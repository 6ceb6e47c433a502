"""fov_per_s (FOV/s): the FOVs whose results reached the host inside the
window, over the window's length."""


def read(window: dict):
    return len(window["latencies_s"]) / window["seconds"]
