"""Row 1, ``resnetc::chain_block_int8``: least time over device time, in %,
counted from the model's shapes: a stride-1 bottleneck block of width C,
whose output width is its ``sw3`` input's length."""

from gpubench import work
from gpubench.readers import roofline_pct

OP = "resnetc::chain_block_int8"
SW3 = 8  # the op's ninth input, sw3 (C,)


def read(r):
    cfg, batch = r.cell.config, r.cell.traffic["batch"]
    return roofline_pct(r, OP, lambda shapes: work.bottleneck_block(cfg, batch, shapes[SW3][0]))
