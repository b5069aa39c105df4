"""Symmetric int8 quantization helpers (plain PyTorch; no kernel).

Counterpart of ``resnetc_tpu/ops/pallas/quant.py:33-48, 224-227``: weights
per output channel, activations with a static calibrated scale, both
round-half-to-even and clipped to +-127.
"""

from __future__ import annotations

import torch


def quantize_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp weights (K, N) -> (int8 (K, N), per-column scale (N,) f32)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Static-scale symmetric int8 quantization."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)
