"""Ops: plain PyTorch ops (``torch_ops``), shape math, and the hand-written
CUDA kernels with their plain versions (``cuda``)."""
