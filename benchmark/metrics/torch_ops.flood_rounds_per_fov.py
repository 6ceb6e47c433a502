"""torch_ops.flood_rounds_per_fov (rounds): fixpoint rounds per FOV in
the profiled slice, read from the port's own span records
(``hiprfish_tpu_torch.utils.logging.RECORDER``): the summed ``rounds`` of
the ``flood.*`` spans (CCL, rank, reach, watershed) inside the recorded
``step`` spans, over the number of those steps. Each round ends in one
host read of its change flag. None where the port keeps no span records
or none of a step."""


def read(trace: dict):
    try:
        from hiprfish_tpu_torch.utils.logging import RECORDER
    except ImportError:
        return None
    spans = RECORDER.snapshot()
    steps = {s["id"] for s in spans if s["name"] == "step"}
    if not steps:
        return None
    return sum(s["attrs"].get("rounds", 0) for s in spans
               if s["step"] in steps
               and s["name"].startswith("flood.")) / len(steps)
