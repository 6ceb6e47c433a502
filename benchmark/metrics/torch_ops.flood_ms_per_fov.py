"""torch_ops.flood_ms_per_fov (ms): host-clock time per FOV spent in the
port's fixpoint floods in the profiled slice, read from the port's own
span records (``hiprfish_tpu_torch.utils.logging.RECORDER``): the summed
durations of the ``flood.*`` spans inside the recorded ``step`` spans,
over the number of those steps. Each flood ends in its own host read, so
its span covers its device work. None where the port keeps no span
records or none of a step."""


def read(trace: dict):
    try:
        from hiprfish_tpu_torch.utils.logging import RECORDER
    except ImportError:
        return None
    spans = RECORDER.snapshot()
    steps = {s["id"] for s in spans if s["name"] == "step"}
    if not steps:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["step"] in steps and s["name"].startswith("flood.")
               and s["end_ns"] is not None) / 1e6 / len(steps)
