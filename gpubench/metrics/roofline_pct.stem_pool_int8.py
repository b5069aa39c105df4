"""``resnetc::stem_pool_int8``, the int8_chain stem's tail: least time over
device time, in %, counted from the op's first input, the stem
convolution's output y (B, H1, W1, C) bf16: y read once, the pooled int8
map (B, H2, W2, C) written once, the bias; no operations counted."""

from gpubench.readers import roofline_pct

OP = "resnetc::stem_pool_int8"


def _count(shapes):
    b, h1, w1, c = shapes[0]
    h2, w2 = (h1 - 1) // 2 + 1, (w1 - 1) // 2 + 1
    return 0, b * h1 * w1 * c * 2 + b * h2 * w2 * c + 2 * c


def read(r):
    return roofline_pct(r, OP, _count)
