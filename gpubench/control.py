"""The control of ``correct``: the plain reference put in the program's place,
one precision below what the configuration states.

The configurations serve residual blocks in int8 and the stem and the fc in
bfloat16.  The control computes every block convolution in int4 and the stem
and the fc in int8: symmetric, weights per output channel, activations per
tensor at their own absolute maximum, products summed exactly in float32.
Its classes, the argmax of its logits, are read with ``check.readings``
against the float32 reference, as the program's are.

``python -m gpubench.control --workload <cell> --seeds <n> ...`` reads, for
each seed in one process, the program's numbers after a short window at the
cell's own load, the same answers with one request's classes altered (the
fault a served answer can have), and on the first seeds the control's on the
same pool; one JSON line a seed: the readings the limits in the
configuration files are set from.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from gpubench import check


def quantize(t: torch.Tensor, bits: int, dims: tuple[int, ...] | None) -> torch.Tensor:
    """Round ``t`` to a symmetric ``bits``-bit grid at its absolute maximum,
    over ``dims`` (per slice) or the whole tensor, and scale back."""
    top = 2 ** (bits - 1) - 1
    amax = t.abs().amax(dim=dims, keepdim=True) if dims else t.abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(t / scale), -top, top) * scale


def lowered(block_bits: int = 4, edge_bits: int = 8) -> dict:
    """The reference's hooks in the lower precision: block convolutions at
    ``block_bits``, the stem and the fc at ``edge_bits``."""

    def conv(name, x, w, stride, padding):
        bits = block_bits if name.startswith("layer") else edge_bits
        return F.conv2d(quantize(x, bits, None), quantize(w, bits, (1, 2, 3)),
                        stride=stride, padding=padding)

    def linear(x, w, b):
        return F.linear(quantize(x, edge_bits, None), quantize(w, edge_bits, (1,)), b)

    return {"conv": conv, "linear": linear}


def control_readings(cfg: dict, params: dict, pool: list[torch.Tensor],
                     ref_logits: list[torch.Tensor]) -> dict:
    """The control's numbers: its classes for every pool batch, read
    against the float32 reference's logits."""
    low = check.reference_logits(cfg, params, pool, **lowered())
    return check.readings(ref_logits, [(i, l.argmax(dim=1)) for i, l in enumerate(low)])


def altered(answers: list, num_classes: int) -> list:
    """The fault of an answer altered where it is produced: the last
    request's classes each moved to the next class."""
    i, classes = answers[-1]
    moved = (torch.as_tensor(classes) + 1) % num_classes
    return [*answers[:-1], (i, moved)]


def main(argv: list[str]) -> int:
    from gpubench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12, help="seeds of the program's readings")
    p.add_argument("--control-seeds", type=int, default=3, help="of those, the control's")
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    dev = run.require_card(1)
    spec = run.load_spec()
    cell = run.Cell.find(spec, args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.seeds):
            seed = args.first_seed + 7919 * k
            state = run.setup(cell, seed, dev)
            state.loop.warm(state.engine, state.pool, state.order, cell.traffic)
            window = state.window(seconds=args.seconds)
            state.free_program()
            ref_logits = state.ref_logits()
            line = {"workload": cell.name, "seed": seed, "requests": window.completed,
                    "program": check.readings(ref_logits, window.answers),
                    "fault": check.readings(
                        ref_logits, altered(window.answers, cell.config["num_classes"]))}
            if k < args.control_seeds:
                line["control"] = control_readings(cell.config, state.params, state.pool,
                                                   ref_logits)
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            del state
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
