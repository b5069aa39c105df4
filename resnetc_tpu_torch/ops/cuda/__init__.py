"""The int8_chain serving path's kernels (CUDA C++ in ``csrc/``), each
beside its plain PyTorch version, and the forward that strings them
together (``fused``).  Nothing here builds or launches at import."""
