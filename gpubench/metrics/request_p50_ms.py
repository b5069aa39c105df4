"""The median request latency of the traced run's window, in ms."""

from gpubench.readers import percentile_ms


def read(r):
    return percentile_ms(r.window.latencies_s, 50)
