"""kernels.stats_cm_roofline_share (%): the summed roofline bound of every
call of ``segstats.stats_cm``, which kernel B5 implements (each call's
labels read once, its labelled voxels' bfloat16 channel rows read once
and its table written once, against the card's memory rate), over the
summed device time of the operations those calls launched. None where no
call was profiled."""


def read(trace: dict):
    dev = trace["op_device_s"].get("stats_cm", 0.0)
    if dev <= 0:
        return None
    return 100.0 * trace["op_bound_s"].get("stats_cm", 0.0) / dev
