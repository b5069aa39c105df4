"""The port's kernels (CUDA C++ in ``csrc/``), each beside its plain PyTorch
version, and the forwards that string them together (``fused``).

Exports the op library of ``resnetc_tpu/ops/pallas/__init__.py:27-34``
under the same names.  Nothing here builds or launches at import: a kernel
is built at its first launch."""

from resnetc_tpu_torch.ops.cuda.gemm import matmul  # noqa: F401
from resnetc_tpu_torch.ops.cuda.conv import (  # noqa: F401
    conv1x1_fused,
    conv3x3_s1_fused,
    conv3x3_s2_fused,
)
from resnetc_tpu_torch.ops.cuda.pool import avg_pool2d, max_pool2d  # noqa: F401
from resnetc_tpu_torch.ops.cuda.elementwise import add, add_relu, relu  # noqa: F401
from resnetc_tpu_torch.ops.cuda.block import bottleneck_block_fused  # noqa: F401
from resnetc_tpu_torch.ops.cuda.fused import fused_forward  # noqa: F401
