"""Top-level host torch ops a request inside ``resnetc.forward``, outside the
kernels' ``resnetc::`` ops: the stem, casts, quantize, pad, the scale rows'
stacks, the head.  A count, the same in every run of one program."""

from gpubench import spans


def read(r):
    got = spans.per_request(r.trace)
    return got[0].torch_ops / got[1] if got else None
