"""Host ms a request inside ``resnetc.forward`` covered by no host operation,
only by program spans: the Python of ``fused.py`` and of the kernels'
wrappers.  Under the profiler, which slows the host."""

from gpubench import spans


def read(r):
    got = spans.per_request(r.trace)
    return got[0].python_ns / 1e6 / got[1] if got else None
