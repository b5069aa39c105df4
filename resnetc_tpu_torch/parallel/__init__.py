"""Data and channel tensor parallelism over ``torch.distributed``: one
process a rank, the batch split over the 'data' axis, the channels of every
parameter over the 'model' axis.

Counterpart of ``resnetc_tpu/parallel`` (same export list).  Process-group
set-up, the batch slices, the logits gather and the single-host launcher
are in ``parallel.distributed``; the shards of a tree in ``parallel.mesh``;
the channel collectives in ``parallel.tp``.
"""

from resnetc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    label_sharding,
    param_shardings,
    replicated,
)
