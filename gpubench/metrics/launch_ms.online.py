"""Host ms a request inside the ``resnetc::`` ops of ``resnetc.forward``: the
dispatcher, the C++ op's checks and its kernel launches.  Under the
profiler."""

from gpubench import spans


def read(r):
    got = spans.per_request(r.trace)
    return got[0].launch_ns / 1e6 / got[1] if got else None
