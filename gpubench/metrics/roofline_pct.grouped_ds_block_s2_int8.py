"""``resnetc::grouped_ds_block_s2_int8``, the stride-2 ResNeXt transition: least
time over device time, in %, counted from the model's shapes
(``work_grouped``): conv1 at the input stage's pixels, the rest at the
output's, the grouped 3x3/2 at its real MACs."""

from gpubench import work_grouped
from gpubench.readers import roofline_pct

OP = "resnetc::grouped_ds_block_s2_int8"


def read(r):
    cfg, batch = r.cell.config, r.cell.traffic["batch"]
    return roofline_pct(r, OP, lambda shapes: work_grouped.grouped_ds_block(cfg, batch, shapes))
