"""Analytic FLOP count of the ResNet family.

Counterpart of ``resnetc_tpu/utils/flops.py:17``.  Multiply-accumulates
count 2 FLOPs, convolutions and fc only (BN, ReLU and pools are
bytes-bound and left out, as in the standard ResNet FLOP figures; the
reference's ~11.5 GFLOPs for ResNet-152 at 224 px uses the same rule).
"""

from __future__ import annotations

from resnetc_tpu_torch.models.resnet import ResNetConfig
from resnetc_tpu_torch.ops.shapes import conv_output_size


def model_flops(cfg: ResNetConfig, image_size: int = 224) -> int:
    """Forward-pass FLOPs per image (2 * MACs, conv + fc)."""
    macs = 0

    def conv(h_in: int, cin: int, cout: int, k: int, stride: int, padding: int) -> int:
        nonlocal macs
        h_out = conv_output_size(h_in, k, stride, padding)
        macs += h_out * h_out * k * k * cin * cout
        return h_out

    h = conv(image_size, 3, cfg.stem_width, 7, 2, 3)
    h = conv_output_size(h, 3, 2, 1)  # max pool: no MACs

    in_c = cfg.stem_width
    for stage in range(4):
        inter, out_c = cfg.stage_channels(stage)
        stride = 1 if stage == 0 else 2
        for b in range(cfg.stage_blocks[stage]):
            s = stride if b == 0 else 1
            if cfg.block == "bottleneck":
                conv(h, in_c, inter, 1, 1, 0)
                # Grouped 3x3 (ResNeXt): each output contracts cin/groups.
                h_new = conv(h, inter // cfg.groups, inter, 3, s, 1)
                conv(h_new, inter, out_c, 1, 1, 0)
            else:
                h_new = conv(h, in_c, inter, 3, s, 1)
                conv(h_new, inter, out_c, 3, 1, 1)
            if b == 0 and (s != 1 or in_c != out_c):
                conv(h, in_c, out_c, 1, s, 0)
            h = h_new
            in_c = out_c

    macs += cfg.feature_dim * cfg.num_classes  # fc
    return 2 * macs
