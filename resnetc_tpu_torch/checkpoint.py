"""Checkpoint I/O: the reference's raw-f32 format and tree interop.

The reference's weights are one headerless little-endian float32 file per
parameter, named by its PyTorch ``state_dict()`` key (save_weights.py:8-12).
On disk conv weights are OIHW; in the port's tree they are HWIO, as in the
JAX package, so the files this module writes are byte-identical to the JAX
package's writer.  Also the torch ``state_dict`` side: import from a
dict or a ``.pth`` file (a raw ``state_dict``, or one wrapped under
``"state_dict"`` / ``"model"``, torchvision's layout included) and export.
And the train state (step, params, BN stats, momentum): saved and restored
with ``torch.save`` / ``torch.load(weights_only=True)`` where the JAX
package uses Orbax.  Counterpart of ``resnetc_tpu/checkpoint.py:85-214``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from resnetc_tpu_torch.models.resnet import ResNetConfig, param_shapes
from resnetc_tpu_torch.train import TrainState
from resnetc_tpu_torch.tensor import (
    flatten_tree, hwio_to_oihw, oihw_to_hwio, tree_map, unflatten_tree,
)

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
    Shapes come from the config; a missing file raises
    ``FileNotFoundError``, an element-count mismatch ``ValueError``.

    The files are read by the native library's thread pool
    (``native.read_f32_many``) where it built, else one at a time with
    ``np.fromfile``, as ``resnetc_tpu/checkpoint.py:124-138`` does."""
    from resnetc_tpu_torch import native

    directory = Path(directory)
    shapes = param_shapes(cfg)
    for key, shape in shapes.items():
        if not (directory / key).exists():
            raise FileNotFoundError(
                f"missing weight file {directory / key} (expected shape {shape})"
            )
    raws = None
    if native.available("binio"):
        keys = list(shapes)
        try:
            arrays = native.read_f32_many([str(directory / k) for k in keys],
                                          [int(np.prod(shapes[k])) for k in keys])
            raws = dict(zip(keys, arrays))
        except ValueError:
            pass  # a size mismatch: the per-file read below names the file
    if raws is None:
        raws = {k: np.fromfile(directory / k, dtype="<f4") for k in shapes}
    flat: dict[str, torch.Tensor] = {}
    for key, shape in shapes.items():
        raw = raws[key]
        if raw.size != int(np.prod(shape)):
            raise ValueError(f"{directory / key}: {raw.size} elems, expected shape {shape}")
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


def torch_state_dict_from_variables(variables: Tree) -> dict[str, torch.Tensor]:
    """Inverse of :func:`variables_from_torch_state_dict`: a flat
    ``state_dict`` of contiguous fp32 CPU tensors (conv weights HWIO ->
    OIHW), e.g. for ``torch.save``."""
    out: dict[str, torch.Tensor] = {}
    for key, leaf in flatten_tree(variables).items():
        arr = torch.as_tensor(leaf).detach().cpu().float()
        if _is_conv_weight(key, tuple(arr.shape)):
            arr = hwio_to_oihw(arr)
        out[key] = arr.contiguous().clone()
    return out


def variables_from_torch_file(path: str | os.PathLike) -> Tree:
    """Load a PyTorch checkpoint file (.pth / .pt) into a variables tree.

    Takes a raw ``state_dict`` or a dict holding one under "state_dict" or
    "model" (the torchvision and training-loop layouts), so a torchvision
    ``resnet152-*.pth`` loads as it is.  Read with ``weights_only=True``:
    tensors and plain containers only.  Anything else raises
    ``ValueError``."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(hasattr(v, "detach") for v in obj.values()):
        for key in ("state_dict", "model"):
            if key in obj:
                obj = obj[key]
                break
    if not isinstance(obj, dict) or not all(hasattr(v, "detach") for v in obj.values()):
        raise ValueError(
            f"{path}: no tensor state_dict found (top-level keys: "
            f"{sorted(obj)[:8] if isinstance(obj, dict) else type(obj).__name__}); "
            "expected a state_dict or a dict with a 'state_dict'/'model' entry"
        )
    return variables_from_torch_state_dict(obj)


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


def train_state_from_jax_numpy(ts) -> TrainState:
    """Carry a JAX-package ``TrainState`` whose leaves were converted to
    numpy (``jax.tree.map(np.asarray, ts)``) into the port: step, params,
    bn_state and momentum as torch tensors on the CPU."""
    return TrainState(
        step=torch.tensor(int(np.asarray(ts.step)), dtype=torch.int32),
        params=variables_from_jax_numpy(ts.params),
        bn_state=variables_from_jax_numpy(ts.bn_state),
        momentum=variables_from_jax_numpy(ts.momentum),
    )


_TRAIN_STATE_FILE = "train_state.pt"
_TRAIN_STATE_TREES = ("params", "bn_state", "momentum")


def save_train_state(directory: str | os.PathLike, ts: TrainState) -> None:
    """Durable training checkpoint (step, params, BN stats, momentum) in
    ``directory``: flat torchvision-keyed CPU tensors, one ``torch.save``
    file; conv weights stay HWIO.

    In a process group every rank calls it: rank 0 writes (data-parallel
    ranks hold equal replicas) and all wait at a barrier until the file is
    in place, the counterpart of JAX's save in which all processes take
    part."""
    import torch.distributed as dist

    in_group = dist.is_initialized()
    if not in_group or dist.get_rank() == 0:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        payload = {"step": ts.step.detach().cpu().clone()}
        for name in _TRAIN_STATE_TREES:
            payload[name] = {
                k: v.detach().cpu().clone() for k, v in flatten_tree(getattr(ts, name)).items()
            }
        tmp = directory / (_TRAIN_STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, directory / _TRAIN_STATE_FILE)
    if in_group:
        dist.barrier()


def load_train_state(directory: str | os.PathLike, like: TrainState) -> TrainState:
    """Restore a checkpoint written by :func:`save_train_state` with the
    structure of ``like``; each leaf goes to the device and dtype of its
    counterpart in ``like``.  A key or shape mismatch raises."""
    obj = torch.load(Path(directory) / _TRAIN_STATE_FILE, map_location="cpu",
                     weights_only=True)
    trees = {}
    for name in _TRAIN_STATE_TREES:
        want = flatten_tree(getattr(like, name))
        got = obj[name]
        if set(got) != set(want):
            diff = sorted(set(got) ^ set(want))[:4]
            raise ValueError(f"{directory}: {name} keys differ from the model's: {diff}")
        flat = {}
        for k, ref in want.items():
            if tuple(got[k].shape) != tuple(ref.shape):
                raise ValueError(f"{directory}: {name}.{k} has shape "
                                 f"{tuple(got[k].shape)}, expected {tuple(ref.shape)}")
            flat[k] = got[k].to(ref.device, ref.dtype)
        trees[name] = unflatten_tree(flat)
    step = obj["step"].to(like.step.device, like.step.dtype)
    return TrainState(step=step, **trees)
