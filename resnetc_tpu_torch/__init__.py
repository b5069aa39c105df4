"""resnetc_tpu_torch — the ResNet serving system in PyTorch with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

A port of ``resnetc_tpu`` (JAX/Pallas on TPU), which stays the reference:
the same parameter trees (torchvision keys, HWIO convs), NHWC activations
and int8 chain layout, so the two can be compared tensor for tensor.  This
package imports neither JAX nor ``resnetc_tpu``.

Entry points run on the card (``device=None`` means CUDA and raises when it
is absent); ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
