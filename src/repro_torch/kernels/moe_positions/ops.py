"""Public wrapper of the position-in-expert kernel: ``flat_e`` (N,) int64,
the flat (token, k) expert ids, token-major → (N,) int64, each id's rank
among the earlier ids of its expert.

The device of the input picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.moe_positions_cuda``) or raise;
    a failed build or launch is never caught;
  * CPU and meta tensors run the plain version (``ref.positions_reference``,
    the one-hot cumsum), so the dry run on meta tensors dispatches and
    counts what it always did;
  * any other device raises.

What the kernel does not take raises on every device (``kernel.check``),
and so does a DTensor: every caller passes its local ids, the mesh paths
adding the counts of the devices before them themselves.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from .kernel import check, moe_positions_cuda
from .ref import positions_reference


def moe_positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    if isinstance(flat_e, DTensor):
        raise TypeError("moe_positions: a DTensor; pass the local ids (to_local())")
    if flat_e.is_cuda:
        return moe_positions_cuda(flat_e, e)  # checks as check() does
    check(flat_e, e)
    if flat_e.device.type in ("cpu", "meta"):
        return positions_reference(flat_e, e)
    raise ValueError(f"moe_positions: no path for tensors on {flat_e.device}")
