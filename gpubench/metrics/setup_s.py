"""The run's set-up: imports, the ops library (built on a first run), inputs,
the engine and the warm-up, up to the window."""


def read(r):
    return r.setup_s
