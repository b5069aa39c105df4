"""The share of the traced span's requests (``spans.roots``) that hold a
``resnetc.replay`` span, in %: requests whose forward was a replay of a
captured CUDA graph.  A program that replays no graph records no such span
and gives nothing."""

from gpubench import spans

REPLAY = "resnetc.replay"


def read(r):
    if r.trace is None:
        return None
    replays, n = spans.named(r.trace, REPLAY), spans.roots(r.trace)
    if not replays or not n:
        return None
    classify = spans.named(r.trace, spans.CLASSIFY)
    roots = classify + [(s, e) for s, e in spans.named(r.trace, spans.LOGITS)
                        if not any(a <= s and e <= b for a, b in classify)]
    held = sum(any(s <= a and b <= e for a, b in replays) for s, e in roots)
    return 100.0 * held / n
