"""step.launches_per_fov: device kernels launched per FOV in the profiled
slice, copies and fills left out."""


def read(trace: dict):
    if trace["n_fovs"] <= 0:
        return None
    return trace["launches"] / trace["n_fovs"]
