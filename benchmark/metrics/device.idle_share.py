"""device.idle_share (%): the share of the profiled slice in which no
client had an operation running on the card (1 - the union of all
clients' device intervals over the slice)."""


def read(trace: dict):
    if trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
