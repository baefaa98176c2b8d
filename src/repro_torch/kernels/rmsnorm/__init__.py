"""Row RMSNorm kernel (CUDA, Hopper).

``ops.rmsnorm`` is the drop-in counterpart of the reference's
``repro.kernels.rmsnorm.ops.rmsnorm`` (x of shape (..., d), scale by
(1 + w)); ``ref.rmsnorm_reference`` is the plain PyTorch version it is
tested against.
"""
from .ops import rmsnorm
from .ref import rmsnorm_reference

__all__ = ["rmsnorm", "rmsnorm_reference"]
