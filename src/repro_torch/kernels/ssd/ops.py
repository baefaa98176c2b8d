"""Public wrapper of the SSD chunk-scan kernel, signature-compatible with
``ref.ssd_reference`` (so ``models/mamba2.py`` swaps implementations by
``RunFlags.ssd_impl``). Returns ``(y, h_final)``: y in x's dtype, h_final
(B, H, P, N) in f32.

The device of the inputs picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.ssd_cuda``) or raise; a failed
    build or launch is never caught;
  * CPU tensors run the plain version (``ref.ssd_reference``);
  * any other device raises.

It keeps the reference's contract: ``chunk = min(chunk, S)`` must divide S.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .kernel import ssd_cuda
from .ref import ssd_reference


def ssd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    s = x.shape[1]
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence length {s}")
    if x.device.type == "cuda":
        # the kernel takes dt and a in f32 (the Pallas kernel casts them) and
        # contiguous operands (the model's x, B and C are slices of one
        # projection)
        return ssd_cuda(x.contiguous(), dt.float().contiguous(), a.float().contiguous(),
                        b_mat.contiguous(), c_mat.contiguous(), chunk)
    if x.device.type == "cpu":
        return ssd_reference(x, dt, a, b_mat, c_mat, chunk=chunk)
    raise ValueError(f"ssd: no path for tensors on {x.device}")
