"""volume.tile_sweep_ms (ms): host-clock time per volume of the tile sweep
of the port's 3D pass in the profiled slice, read from the port's own
span records (``hiprfish_tpu_torch.utils.logging.RECORDER``): the summed
durations of the ``tiles`` spans of ``segment3d.segment_3d_tiled``
inside the recorded ``step`` spans, over the number of those steps. The
sweep's floods end in host reads, so the span covers its device work up
to the last tile's. None where the port keeps no span records or none of
a step with a tile sweep."""


def read(trace: dict):
    try:
        from hiprfish_tpu_torch.utils.logging import RECORDER
    except ImportError:
        return None
    spans = RECORDER.snapshot()
    steps = {s["id"] for s in spans if s["name"] == "step"}
    sweeps = [s for s in spans if s["step"] in steps and s["name"] == "tiles"
              and s["end_ns"] is not None]
    if not sweeps:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in sweeps) / 1e6 \
        / len(steps)
