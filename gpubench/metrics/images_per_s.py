"""Images whose classes reached the host inside the window, over its seconds."""


def read(r):
    return r.window.images / r.window.seconds if r.window.images else None
