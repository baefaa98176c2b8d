"""The flash-attention kernel's plain PyTorch version: dense masked causal
(or full) GQA attention in f32, in the kernel's (B, H, S, Dh) layout."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,  # (B, H, Sq, Dh)
    k: torch.Tensor,  # (B, KH, Skv, Dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    b, h, sq, dh = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, sq, dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, dh).to(q.dtype)
