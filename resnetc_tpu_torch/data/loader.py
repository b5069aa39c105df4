"""Synthetic training batches.

Counterpart of ``resnetc_tpu/data/loader.py:152 synthetic_batches``.  The
host-side ``BatchLoader`` and the ImageFolder pipeline are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from resnetc_tpu_torch.data.preprocess import DEFAULT_CROP
from resnetc_tpu_torch.tensor import resolve_device


def synthetic_batches(
    *,
    batch_size: int,
    image_size: int = DEFAULT_CROP,
    steps: int,
    num_classes: int = 1000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Deterministic fake (images NHWC fp32, labels int32) batches for
    benchmarks and tests: the JAX package's numpy draws from
    ``default_rng(seed)``, so both packages see the same arrays.  Made once
    and copied to the device once (the card unless ``device="cpu"``); the
    same batch is yielded ``steps`` times."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, image_size, image_size, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(batch_size,)).astype(np.int32)
    dev_images = torch.from_numpy(images).to(dev)
    dev_labels = torch.from_numpy(labels).to(dev)
    for _ in range(steps):
        yield dev_images, dev_labels
