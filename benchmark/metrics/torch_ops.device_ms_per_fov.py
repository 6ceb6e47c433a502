"""torch_ops.device_ms_per_fov (ms): device time per FOV of every
operation (kernels, copies, fills) launched outside the four entry
functions that kernels B1-B4 implement."""


def read(trace: dict):
    if trace["n_fovs"] <= 0:
        return None
    return 1e3 * trace["other_device_s"] / trace["n_fovs"]
