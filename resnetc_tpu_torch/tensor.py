"""Array conventions, dtype policy and device selection.

The port keeps the JAX package's public layouts so the two can be compared
tensor for tensor:

- **NHWC activations** at every public function (PyTorch's own convolution
  wants NCHW; the ops in ``resnetc_tpu_torch.ops.torch_ops`` transpose at
  their boundary);
- **HWIO conv weights** (torchvision stores OIHW; the checkpoint importer
  transposes on load);
- **a dtype policy**: parameters in fp32, compute in bf16 with fp32
  accumulation, outputs in fp32.  ``FP32`` is the parity mode.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """What dtype each class of tensor uses.

    ``compute`` is applied to activations and weights at op boundaries;
    accumulation inside matmuls/convs is always fp32, never the compute
    dtype.
    """

    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    output: torch.dtype = torch.float32


#: fp32 everywhere — the parity mode.
FP32 = DtypePolicy(param=torch.float32, compute=torch.float32, output=torch.float32)

#: bf16 compute / fp32 accumulate — the serving default.
BF16 = DtypePolicy(param=torch.float32, compute=torch.bfloat16, output=torch.float32)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises instead of silently running on the CPU when CUDA is absent; a
    caller that wants the CPU (the tests) asks for it by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'layer1.0.conv1.weight': leaf, ...} (torchvision keys)."""
    out: dict = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Layout shim at the PyTorch-world boundary (inputs arrive NCHW)."""
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    """Conv-weight layout shim: PyTorch state_dict OIHW -> HWIO."""
    return w.permute(2, 3, 1, 0)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)
