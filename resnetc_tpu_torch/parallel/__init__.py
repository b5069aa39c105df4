"""Data parallelism over ``torch.distributed``: one process a rank, a
replica of the weights on each, the batch split over the 'data' axis.

Counterpart of ``resnetc_tpu/parallel`` (same export list).  Process-group
set-up, the batch slices, the logits gather and the single-host launcher
are in ``parallel.distributed``.
"""

from resnetc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    label_sharding,
    param_shardings,
    replicated,
)
