"""Checkpoint I/O: the reference's raw-f32 format and tree interop.

The reference's weights are one headerless little-endian float32 file per
parameter, named by its PyTorch ``state_dict()`` key (save_weights.py:8-12).
On disk conv weights are OIHW; in the port's tree they are HWIO, as in the
JAX package, so the files this module writes are byte-identical to the JAX
package's writer.  Counterpart of ``resnetc_tpu/checkpoint.py:85-190``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from resnetc_tpu_torch.models.resnet import ResNetConfig, param_shapes
from resnetc_tpu_torch.tensor import flatten_tree, oihw_to_hwio, tree_map, unflatten_tree

Tree = dict[str, Any]

# state_dict keys the engine ignores (BatchNorm bookkeeping).
_IGNORED_KEYS = ("num_batches_tracked",)


def _is_conv_weight(key: str, shape: tuple[int, ...]) -> bool:
    # Conv weights are the only rank-4 tensors in a ResNet state dict.
    return key.endswith("weight") and len(shape) == 4


def save_reference_format(variables: Tree, directory: str | os.PathLike) -> int:
    """Write a variables tree as the reference's weight files (HWIO -> OIHW).
    Returns the number of files written."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = flatten_tree(variables)
    for key, leaf in flat.items():
        arr = torch.as_tensor(leaf).detach().cpu().float().numpy()
        if _is_conv_weight(key, arr.shape):
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        arr.astype("<f4").tofile(directory / key)
    return len(flat)


def load_reference_format(
    cfg: ResNetConfig,
    directory: str | os.PathLike,
    *,
    dtype: torch.dtype = torch.float32,
) -> Tree:
    """Load a reference weight directory into a variables tree (CPU).
    Shapes come from the config; element-count mismatches raise."""
    directory = Path(directory)
    flat: dict[str, torch.Tensor] = {}
    for key, shape in param_shapes(cfg).items():
        path = directory / key
        if not path.exists():
            raise FileNotFoundError(f"missing weight file {path} (expected shape {shape})")
        raw = np.fromfile(path, dtype="<f4")
        if raw.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {raw.size} elems, expected shape {shape}")
        if _is_conv_weight(key, shape):
            h, w, i, o = shape
            arr = raw.reshape(o, i, h, w).transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            arr = raw.reshape(shape)
        flat[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    return unflatten_tree(flat)


def variables_from_torch_state_dict(state_dict: Mapping[str, Any]) -> Tree:
    """A torch ``state_dict()`` -> variables tree (conv weights OIHW -> HWIO)."""
    flat: dict[str, torch.Tensor] = {}
    for key, t in state_dict.items():
        if any(key.endswith(sfx) for sfx in _IGNORED_KEYS):
            continue
        arr = t.detach().cpu().float()
        if _is_conv_weight(key, tuple(arr.shape)):
            arr = oihw_to_hwio(arr)
        flat[key] = arr.contiguous()
    return unflatten_tree(flat)


def variables_from_jax_numpy(tree: Tree) -> Tree:
    """Carry a JAX-package tree, already converted to numpy leaves, into the
    port: same nesting and layouts (HWIO convs), torch tensors on the CPU.

    Works for a parameter tree, a quantized tree and a ``chain_scales`` tree
    alike (its scalar leaves become 0-d float32 tensors).  Float leaves of
    other widths, bfloat16 included (numpy has no such type of its own),
    become float32."""

    def leaf(a):
        arr = np.asarray(a)
        if arr.dtype != np.float32 and (arr.dtype.kind == "f" or arr.dtype.name == "bfloat16"):
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr, copy=True))

    return tree_map(leaf, tree)
