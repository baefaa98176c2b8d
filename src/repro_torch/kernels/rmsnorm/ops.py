"""Public wrapper of the RMSNorm kernel: x of shape (..., d), normalised
over its last axis.

The device of the inputs picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.rmsnorm_cuda``) or raise; a
    failed build or launch is never caught;
  * CPU tensors run the plain version (``ref.rmsnorm_reference``);
  * any other device raises.

``row_block`` is the reference's tiling knob and is kept in the signature;
the CUDA kernel picks its own tiling (a warp or a block per row), so here
any row count works, where the Pallas kernel needs ``row_block`` to divide it.
"""
from __future__ import annotations

import torch

from .kernel import rmsnorm_cuda
from .ref import rmsnorm_reference


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            row_block: int = 256) -> torch.Tensor:
    if row_block <= 0:
        raise ValueError(f"row_block must be positive, got {row_block}")
    if x.is_cuda:
        if x.dim() == 2:  # no views to make: the decode and prefill rows of a 2-D call
            return rmsnorm_cuda(x.contiguous(), w.contiguous(), eps)
        return rmsnorm_cuda(x.reshape(-1, x.shape[-1]).contiguous(), w.contiguous(), eps).view(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_reference(x, w, eps)
    raise ValueError(f"rmsnorm: no path for tensors on {x.device}")
