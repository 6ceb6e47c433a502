"""kernels.roofline_share (%): the summed roofline bound of every call of
the four entry functions that kernels B1-B4 implement (NLM, LP-CV 2D,
label stats, label lookup), counted from each call's arguments, over the
summed device time of the operations those calls launched."""


def read(trace: dict):
    dev = sum(trace["op_device_s"].values())
    if dev <= 0:
        return None
    return 100.0 * sum(trace["op_bound_s"].values()) / dev
