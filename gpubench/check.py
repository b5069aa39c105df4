"""The comparison that decides ``correct``: the classes the timed path served,
against the plain float32 reference's logits for the same images.

``class_gap`` is compared with its limit in the configuration's ``limits``:
the widest gap, over every answer checked, by which the reference's logit of
the served class lies below the reference's best logit for that image, in
units of the standard deviation of that image's reference logits over the
classes.  ``mismatch_pct``, the share of answers whose class is not the
reference's best, is read beside it and not compared: with random weights
most images have near ties, and the int4 control does not read three times
what the program does on every configuration.

The reference runs after the window, one pool batch at a time, once for all
the answers served for that batch.
"""

from __future__ import annotations

import torch

from gpubench import references


def reference_logits(cfg: dict, params: dict, pool: list[torch.Tensor], **hooks) -> list:
    """The reference's float32 logits of each pool batch."""
    ref = references.of(cfg)
    with torch.no_grad(), ref.exact_fp32():
        return [ref.forward(cfg, params, x, **hooks) for x in pool]


def readings(ref_logits: list[torch.Tensor], answers: list[tuple[int, torch.Tensor]]) -> dict:
    """``class_gap`` and ``mismatch_pct`` of ``answers``, (pool index, served
    classes) pairs, against the reference's logits of each pool batch."""
    gap, wrong, n = 0.0, 0, 0
    by_batch: dict[int, list[torch.Tensor]] = {}
    for i, classes in answers:
        by_batch.setdefault(i, []).append(torch.as_tensor(classes).long().reshape(-1))
    for i, served in by_batch.items():
        r = ref_logits[i].float()
        best, std = r.max(dim=1).values, r.std(dim=1)
        served = torch.stack(served).to(r.device)  # (answers, batch)
        got = r.gather(1, served.t()).t()
        gap = max(gap, float(((best - got) / std).max()))
        wrong += int((got < best).sum())
        n += served.numel()
    return {"class_gap": gap, "mismatch_pct": 100.0 * wrong / max(n, 1)}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number that has a limit is within it, and each such
    number beside its limit."""
    shown = {k: {"value": values[k], "limit": limit} for k, limit in limits.items()}
    return all(values[k] <= limit for k, limit in limits.items()), shown
