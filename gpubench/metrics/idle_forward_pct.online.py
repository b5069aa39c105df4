"""The share of the traced span's device-idle time that falls inside
``resnetc.forward`` spans, by interval overlap, in %: the idle time the
program's launch path leaves, as against the client's and the readout's."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    forwards, gaps = spans.named(r.trace, spans.FORWARD), r.trace.gaps()
    idle = sum(e - s for s, e in gaps)
    if not forwards or idle <= 0:
        return None
    return 100.0 * spans.overlap_ns(gaps, forwards) / idle
