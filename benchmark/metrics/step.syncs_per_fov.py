"""step.syncs_per_fov: host calls that block until the device has caught
up (stream, device and event synchronisations, blocking copies) per FOV
in the profiled slice."""


def read(trace: dict):
    if trace["n_fovs"] <= 0:
        return None
    return trace["syncs"] / trace["n_fovs"]
