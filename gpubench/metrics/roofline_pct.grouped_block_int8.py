"""``resnetc::grouped_block_int8``, the stride-1 ResNeXt block: least time over
device time, in %, counted from the model's shapes (``work_grouped``): the
grouped 3x3 at its real MACs, whatever the kernel's tiles pad."""

from gpubench import work_grouped
from gpubench.readers import roofline_pct

OP = "resnetc::grouped_block_int8"


def read(r):
    cfg, batch = r.cell.config, r.cell.traffic["batch"]
    return roofline_pct(r, OP, lambda shapes: work_grouped.grouped_block(cfg, batch, shapes))
