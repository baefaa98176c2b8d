"""The MoE position-in-expert computation's plain PyTorch version: the
reference's token-major one-hot cumsum (``src/repro/models/moe.py``
``moe_apply``), as ``models.moe.positions`` computed it before the kernel."""
from __future__ import annotations

import torch


def positions_reference(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each flat assignment's place in its expert's queue, by a token-major
    one-hot cumsum (T·k, E): earlier tokens win capacity."""
    onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).to(torch.int32)
    return ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
