"""sweep.fov_ms_p95 (ms): the 95th percentile of the latencies of every
FOV completed in the traced run's window, from handing the FOV to the
step until its results are on the host (numpy's linear interpolation).
The profiler, once started in set-up, slows every launch of the process
for the rest of the run, so the number reads above an untraced run's."""

import numpy as np


def read(trace: dict):
    lat = trace.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
