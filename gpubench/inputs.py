"""Everything a run feeds the program and the reference, made from the seed on
the device: the weights, the calibration images and the traffic's image pool.

Weights follow torchvision's init (kaiming normal, fan out, for every conv;
the fc uniform in +-1/sqrt(features)), drawn in one call for all the convs.
BN is drawn off the identity, as a trained network has it: scale and shift
from the seed, the last BN of every residual branch smaller, and the running
statistics those of the activations that reach each BN over the calibration
images, then moved by a seeded draw, so that no BN normalises its input
exactly.  The fc bias is then centred on those images' mean logits, so that
the classes vary over images.  The seed fixes all of it.

Images are NHWC float32 in the range of ImageNet-normalised pixels, whose
brightness, colour, contrast and detail differ from image to image, so that
the network's pooled features, and so its classes, differ between images.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench import references

#: (0 - mean) / std and (1 - mean) / std over ImageNet's channel statistics.
PIXEL_LO, PIXEL_HI = (0 - 0.485) / 0.229, (1 - 0.406) / 0.225


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def images(gen: torch.Generator, n: int, side: int, spec: dict) -> torch.Tensor:
    """``n`` NHWC float32 images whose global statistics differ from image
    to image, as photographs' do: a field at each of ``scales`` (cells
    across the image) upsampled bilinearly, plus pixel noise, each at a
    weight drawn per image up to ``amplitude``, plus a per-image offset of
    each channel up to +-``offset``, clipped to the normalised pixel range."""
    dev = gen.device
    scales = spec["scales"]
    weight = torch.rand((n, len(scales) + 1, 1, 1, 1), generator=gen, device=dev)
    weight = weight * spec["amplitude"]
    x = torch.randn((n, 3, side, side), generator=gen, device=dev) * weight[:, -1]
    for j, cells in enumerate(scales):
        field = torch.randn((n, 3, cells, cells), generator=gen, device=dev)
        x += F.interpolate(field, size=(side, side), mode="bilinear",
                           align_corners=False) * weight[:, j]
    x += (2 * torch.rand((n, 3, 1, 1), generator=gen, device=dev) - 1) * spec["offset"]
    return x.clamp_(PIXEL_LO, PIXEL_HI).permute(0, 2, 3, 1).contiguous()


def weights(cfg: dict, gen: torch.Generator, calib: torch.Tensor) -> dict[str, torch.Tensor]:
    """The float32 weights of ``cfg`` under torchvision's names (convs
    OIHW), on the generator's device."""
    dev, ref = gen.device, references.of(cfg)
    shapes = ref.param_shapes(cfg)
    convs = [k for k, s in shapes.items() if len(s) == 4]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in convs), generator=gen, device=dev)
    params: dict[str, torch.Tensor] = {}
    at = 0
    for k in convs:
        n = math.prod(shapes[k])
        params[k] = flat[at:at + n].view(shapes[k]).mul_(ref.kaiming_std(shapes[k]))
        at += n

    bn = cfg["bn"]
    bns = sorted({k.rsplit(".", 1)[0] for k, s in shapes.items() if k.endswith("running_var")})
    widths = [shapes[f"{b}.weight"][0] for b in bns]
    draws = torch.rand((4, sum(widths)), generator=gen, device=dev)
    at = 0
    for b, w in zip(bns, widths):
        u = draws[:, at:at + w]
        at += w
        lo, hi = bn["last_scale"] if _last_of_branch(cfg, b) else bn["scale"]
        params[f"{b}.weight"] = lo + (hi - lo) * u[0]
        params[f"{b}.bias"] = bn["shift"] * (2 * u[1] - 1)
        params[f"{b}.running_mean"] = u[2]  # replaced from the activations below
        params[f"{b}.running_var"] = u[3]

    feat = shapes["fc.weight"][1]
    u = torch.rand((cfg["num_classes"], feat + 1), generator=gen, device=dev)
    params["fc.weight"] = (2 * u[:, :feat] - 1) / feat**0.5
    params["fc.bias"] = (2 * u[:, feat] - 1) / feat**0.5

    def set_stats(name: str, x: torch.Tensor) -> None:
        # The draws kept in running_mean / running_var move the statistics
        # of what reaches this BN: the mean by up to mean_shift of a std,
        # the variance by a factor in var_scale.
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-6)
        u_mean, u_var = params[f"{name}.running_mean"], params[f"{name}.running_var"]
        lo, hi = bn["var_scale"]
        params[f"{name}.running_mean"] = mean + bn["mean_shift"] * (2 * u_mean - 1) * var.sqrt()
        params[f"{name}.running_var"] = var * (lo + (hi - lo) * u_var)

    with torch.no_grad(), ref.exact_fp32():
        logits = ref.forward(cfg, params, calib, bn_hook=set_stats)
        params["fc.bias"] = params["fc.bias"] - logits.mean(dim=0)
    return params


def _last_of_branch(cfg: dict, bn_name: str) -> bool:
    """The BN that closes a residual branch (bn3 of a bottleneck, bn2 of a
    basic block): a trained network keeps its scale small."""
    last = "bn3" if cfg["block"] == "bottleneck" else "bn2"
    return bn_name.startswith("layer") and bn_name.endswith("." + last)


def program_tree(params: dict[str, torch.Tensor]) -> dict:
    """The program's form of the same weights: a nested dict under the same
    names, convolutions HWIO.  Copies, so that nothing the program does to
    its tree reaches the reference's."""
    tree: dict = {}
    for key, v in params.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = (v.permute(2, 3, 1, 0) if v.ndim == 4 else v).contiguous().clone()
    return tree
