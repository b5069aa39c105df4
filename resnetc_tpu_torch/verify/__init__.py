from resnetc_tpu_torch.verify.harness import LogitReport, compare_logits  # noqa: F401
