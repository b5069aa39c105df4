"""Row 7, ``resnetc::basic_block_int8``: least time over device time, in %,
counted from the model's shapes: a stride-1 basic block of width C, whose
input chain has C channels."""

from gpubench import work
from gpubench.readers import roofline_pct

OP = "resnetc::basic_block_int8"


def read(r):
    cfg, batch = r.cell.config, r.cell.traffic["batch"]
    return roofline_pct(r, OP, lambda shapes: work.basic_block(cfg, batch, shapes[0][-1]))
