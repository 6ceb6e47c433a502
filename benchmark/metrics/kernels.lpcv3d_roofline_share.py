"""kernels.lpcv3d_roofline_share (%): the summed roofline bound of every
call of ``line_profile.lp_cv_enhance_3d``, which kernel B6 implements
(``benchmark/kernel_work.py``'s operations of the (11, 9, 9) stencil per
voxel against the card's f32 peak), over the summed device time of the
operations those calls launched. None where no call was profiled."""


def read(trace: dict):
    dev = trace["op_device_s"].get("lpcv3d", 0.0)
    if dev <= 0:
        return None
    return 100.0 * trace["op_bound_s"].get("lpcv3d", 0.0) / dev
