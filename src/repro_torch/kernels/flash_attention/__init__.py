"""Flash-attention forward kernel (CUDA, Hopper).

``ops.flash_attention`` is the drop-in counterpart of the reference's
``repro.kernels.flash_attention.ops.flash_attention`` (model layout
(B, S, H, Dh)), differentiable under autograd (the kernel's forward with
the row log-sum-exp, the plain flash backward of ``models.flash_ref``);
``ref.attention_reference`` is the plain PyTorch version it is tested
against.
"""
from .ops import flash_attention
from .ref import attention_reference

__all__ = ["attention_reference", "flash_attention"]
