"""Host ms a request inside ``resnetc.forward`` spent in host operations other
than the ``resnetc::`` ops: torch's own ops for the stem, casts, quantize,
pad, scale rows and head, and any runtime call outside an op.  Under the
profiler."""

from gpubench import spans


def read(r):
    got = spans.per_request(r.trace)
    return got[0].torch_ns / 1e6 / got[1] if got else None
