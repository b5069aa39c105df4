"""The plain references, one module a family, named by a configuration's
``reference``.  Each has ``param_shapes(cfg)``, ``forward(cfg, params, x,
conv=, linear=, bn_hook=)``, ``kaiming_std(shape)`` and ``exact_fp32()``."""

from __future__ import annotations

import importlib


def of(cfg: dict):
    return importlib.import_module(f"gpubench.references.{cfg['reference']}")
