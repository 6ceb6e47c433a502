"""setup_s (s): from the process's start to the window's start: imports,
the kernel library (built in a checkout's first run), the device
context, the classifier, the scenes' geometries and the warm-up steps."""


def read(window: dict):
    return window["setup_s"]
