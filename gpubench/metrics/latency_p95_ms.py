"""The 95th percentile of every request completed in the window, in ms."""

from gpubench.readers import percentile_ms


def read(r):
    return percentile_ms(r.window.latencies_s, 95)
