"""The yardstick's arithmetic: operations and bytes counted from the model's
shapes, and the card's published peaks.

``model_flops`` is a frozen copy of the program's ``utils.flops.model_flops``
(2 operations a multiply-accumulate, convolutions and the fc only).  The
block counts follow the model's shapes, not a kernel's padded layout: each
input, output and weight byte of a block once, int8.
"""

from __future__ import annotations

from gpubench.references.resnet import block_convs, blocks, stage_size, stage_widths

#: NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def _out(side: int, k: int, stride: int) -> int:
    return (side + 2 * (k // 2) - k) // stride + 1


def model_flops(cfg: dict) -> int:
    """Operations of one image's forward: 2 x MACs of every conv and the fc."""
    macs = 0
    side = _out(cfg["image_size"], 7, 2)
    macs += side * side * 49 * 3 * cfg["stem_width"]
    side = _out(side, 3, 2)
    strided = 1 if cfg["block"] == "bottleneck" else 0
    for _, _, cin, inner, cout, stride, proj in blocks(cfg):
        for i, (_, k, ci, co) in enumerate(block_convs(cfg, cin, inner, cout)):
            if i == strided:
                side = _out(side, k, stride)
            macs += side * side * k * k * ci * co
        if proj:
            macs += side * side * cin * cout
    macs += stage_widths(cfg, 3)[1] * cfg["num_classes"]
    return 2 * macs


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the int8 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES)


def _pixels(cfg: dict, batch: int, width: int, inner: bool) -> int:
    """Pixels of the stage whose blocks have this width (inner or output)."""
    for stage in range(4):
        if stage_widths(cfg, stage)[0 if inner else 1] == width:
            side = stage_size(cfg, stage)
            return batch * side * side
    raise ValueError(f"no stage of {cfg['name']} has blocks of width {width}")


def bottleneck_block(cfg: dict, batch: int, width: int) -> tuple[float, float]:
    """(operations, bytes) of one stride-1 identity bottleneck block of output
    width C over a batch: 1x1 C -> C/4, 3x3 C/4 -> C/4, 1x1 C/4 -> C."""
    px = _pixels(cfg, batch, width, inner=False)
    q = width // 4
    ops = 2 * px * (width * width / 2 + 9 * q * q)
    weights = 2 * width * q + 9 * q * q
    return ops, 2 * px * width + weights


def basic_block(cfg: dict, batch: int, width: int) -> tuple[float, float]:
    """(operations, bytes) of one stride-1 identity basic block of width C
    over a batch: two 3x3 C -> C."""
    px = _pixels(cfg, batch, width, inner=True)
    ops = 2 * px * 18 * width * width
    return ops, 2 * px * width + 18 * width * width
