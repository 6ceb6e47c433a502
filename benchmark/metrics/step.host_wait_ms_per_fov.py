"""step.host_wait_ms_per_fov (ms): host time per FOV blocked in the
step's reads of device values in the profiled slice, read from the
port's own span records (``hiprfish_tpu_torch.utils.logging.RECORDER``):
the summed ``wait_ns`` of every span inside the recorded ``step`` spans,
over the number of those steps. It counts the reads the port routes
through ``utils.logging.host_wait``: each fixpoint round's change test,
the registration shifts, the cell and hole counts and the kept-cell
index; the syncs hidden inside other torch operators (a bincount, a
scalar store, a host-to-device copy, a boolean index) are not in it. The
rest of the host's time in a step is issuing work. None where the port
keeps no span records or none of a step."""


def read(trace: dict):
    try:
        from hiprfish_tpu_torch.utils.logging import RECORDER
    except ImportError:
        return None
    spans = RECORDER.snapshot()
    steps = {s["id"] for s in spans if s["name"] == "step"}
    if not steps:
        return None
    return sum(s["attrs"].get("wait_ns", 0) for s in spans
               if s["step"] in steps) / 1e6 / len(steps)
