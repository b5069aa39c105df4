"""Parity comparisons between two sets of logits.

Counterpart of ``resnetc_tpu/verify/harness.py:22-52``: assertable metrics
in place of the reference's manual dump/allclose loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LogitReport:
    mae: float
    max_abs_err: float
    argmax_match_rate: float
    top1_ours: np.ndarray
    top1_ref: np.ndarray

    @property
    def argmax_match(self) -> bool:
        return self.argmax_match_rate == 1.0


def compare_logits(ours, ref) -> LogitReport:
    """Compare two (B, classes) logit arrays (numpy or CPU/GPU tensors)."""
    ours = _to_numpy(ours)
    ref = _to_numpy(ref)
    if ours.shape != ref.shape:
        raise ValueError(f"logit shape mismatch: {ours.shape} vs {ref.shape}")
    err = np.abs(ours - ref)
    top1_ours = ours.argmax(axis=-1)
    top1_ref = ref.argmax(axis=-1)
    return LogitReport(
        mae=float(err.mean()),
        max_abs_err=float(err.max()),
        argmax_match_rate=float((top1_ours == top1_ref).mean()),
        top1_ours=top1_ours,
        top1_ref=top1_ref,
    )


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)
