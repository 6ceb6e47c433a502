"""volume.merge_ms (ms): host-clock time per volume of the merge of the
port's 3D pass in the profiled slice, read from the port's own span
records (``hiprfish_tpu_torch.utils.logging.RECORDER``): the summed
durations of the ``merge`` spans of ``segment3d.segment_3d_tiled`` (the
read-backs of the tiles' presence bitmaps and boundary pair sets, the
host union-find over the tile boundaries and the remap table) inside the
recorded ``step`` spans, over the number of those steps. None where the
port keeps no span records or none of a step with a merge."""


def read(trace: dict):
    try:
        from hiprfish_tpu_torch.utils.logging import RECORDER
    except ImportError:
        return None
    spans = RECORDER.snapshot()
    steps = {s["id"] for s in spans if s["name"] == "step"}
    merges = [s for s in spans if s["step"] in steps and s["name"] == "merge"
              and s["end_ns"] is not None]
    if not merges:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in merges) / 1e6 \
        / len(steps)
