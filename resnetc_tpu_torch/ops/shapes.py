"""Static shape math shared by ops, modules, and model assembly.

Same formula as the reference's ``convOutputSize`` (cuda/ops.cuh:9-13).
"""

from __future__ import annotations


def conv_output_size(size: int, kernel_size: int, stride: int, padding: int) -> int:
    """Output spatial extent of a conv/pool window:
    ``(2*padding + size - kernel_size) // stride + 1``."""
    if size + 2 * padding < kernel_size:
        raise ValueError(
            f"window (k={kernel_size}) larger than padded input ({size}+2*{padding})"
        )
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    return (2 * padding + size - kernel_size) // stride + 1


# Pooling uses the same window arithmetic (cuda/nn.cuh:87-94).
pool_output_size = conv_output_size
