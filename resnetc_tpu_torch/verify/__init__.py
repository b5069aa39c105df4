"""Numeric-parity verification: the PyTorch twin (``twin``) and the
reports that hold the port's model against it (``harness``)."""

from resnetc_tpu_torch.verify.harness import (  # noqa: F401
    LogitReport,
    compare_logits,
    logit_report,
    stage_parity_report,
)
