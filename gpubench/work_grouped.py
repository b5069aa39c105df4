"""The yardstick's arithmetic for the grouped configurations (ResNeXt):
operations and bytes counted from the model's shapes
(``references.resnext``), as ``work`` counts them for the ungrouped ones.

``model_flops`` is 2 operations a multiply-accumulate of every convolution
and the fc, a grouped 3x3 counted at its real MACs (9 W W / groups a
pixel).  A block launch's counts follow the model's shapes, not the kernel's
padded layout: per output pixel 2 (cin W + 9 W W / G + W C [+ cin C])
operations (conv1 at the input pixels where the block strides), and each
input, output and weight byte once, int8.
"""

from __future__ import annotations

from gpubench.references.resnext import blocks, stage_size, stage_widths
from gpubench.work import _out


def model_flops(cfg: dict) -> int:
    """Operations of one image's forward: 2 x MACs of every conv and the fc."""
    g = cfg["groups"]
    side = _out(cfg["image_size"], 7, 2)
    macs = side * side * 49 * 3 * cfg["stem_width"]
    side = _out(side, 3, 2)
    for _, _, cin, inner, cout, stride, proj in blocks(cfg):
        macs += side * side * cin * inner  # conv1, at the block's input
        side = _out(side, 3, stride)
        macs += side * side * (9 * inner * inner // g + inner * cout + (cin * cout if proj else 0))
    macs += stage_widths(cfg, 3)[1] * cfg["num_classes"]
    return 2 * macs


def _stage_of(cfg: dict, inner: int) -> int:
    for stage in range(4):
        if stage_widths(cfg, stage)[0] == inner:
            return stage
    raise ValueError(f"no stage of {cfg['name']} has an inner width of {inner}")


def grouped_block(cfg: dict, batch: int, shapes: list) -> tuple[float, float]:
    """(operations, bytes) of one ``resnetc::grouped_block_int8`` launch from
    its input shapes: x (rows, cin), w1_nk (W, cin), ..., w3_nk (C, W) at
    index 7; a stride-1 block of the stage whose inner width is W."""
    cin, (inner, _), cout = shapes[0][1], shapes[1], shapes[7][0]
    side = stage_size(cfg, _stage_of(cfg, inner))
    px = batch * side * side
    proj = cin != cout
    weights = cin * inner + 9 * inner * inner // cfg["groups"] + inner * cout
    weights += cin * cout if proj else 0
    return 2 * px * weights, px * (cin + cout) + weights


def grouped_ds_block(cfg: dict, batch: int, shapes: list) -> tuple[float, float]:
    """(operations, bytes) of one ``resnetc::grouped_ds_block_s2_int8``
    launch from its input shapes: conv1 over the input stage's pixels, the
    grouped 3x3/2, conv3 and the 1x1/2 projection over the output's."""
    cin, (inner, _), cout = shapes[0][1], shapes[1], shapes[7][0]
    stage = _stage_of(cfg, inner)
    px_in = batch * stage_size(cfg, stage - 1) ** 2
    px = batch * stage_size(cfg, stage) ** 2
    rest = 9 * inner * inner // cfg["groups"] + inner * cout + cin * cout
    ops = 2 * (px_in * cin * inner + px * rest)
    weights = cin * inner + rest
    return ops, px_in * cin + px * cout + weights
