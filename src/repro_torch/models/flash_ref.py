"""Blockwise causal GQA attention, FlashAttention-style [arXiv:2205.14135,
2307.08691], in plain torch: the forward pass of ``repro.models.flash_ref``.

Layout: q (B, Sq, H, Dh); k, v (B, Skv, K, Dh); GQA via grouped reshape.
Forward math in f32 online softmax; the output keeps q's dtype, the row
log-sum-exp is f32. This is what ``attn_impl="blockwise"`` runs (and
``"auto"`` beyond 1024 tokens). The reference's custom VJP becomes a
``torch.autograd.Function`` with the training slice; serving needs only the
forward.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30

_F32 = torch.float32


def _fwd_impl(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_block: int, kv_block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, H, Dh) in q's dtype, lse (B, Sq, K, G) f32)."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide ({sq}, {skv})")
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    outs, lses = [], []
    for iq in range(sq // q_block):
        qi = q[:, iq * q_block:(iq + 1) * q_block].reshape(b, q_block, kh, g, dh).to(_F32)
        rows = iq * q_block + torch.arange(q_block, device=dev)
        m = torch.full((b, kh, g, q_block), NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((b, kh, g, q_block), dtype=_F32, device=dev)
        acc = torch.zeros((b, kh, g, q_block, dh), dtype=_F32, device=dev)
        for jk in range(skv // kv_block):
            sl = slice(jk * kv_block, (jk + 1) * kv_block)
            cols = jk * kv_block + torch.arange(kv_block, device=dev)
            s_blk = torch.einsum("bqkgd,bskd->bkgqs", qi, k[:, sl].to(_F32)) * scale
            if causal:
                s_blk = torch.where(rows[:, None] >= cols[None, :], s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(-1))
            p = torch.exp(s_blk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v[:, sl].to(_F32))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))  # (B, qb, K, G, Dh)
        lses.append((m + torch.log(l)).permute(0, 3, 1, 2))  # (B, qb, K, G)
    out = torch.cat(outs, 1).reshape(b, sq, h, dh).to(q.dtype)
    return out, torch.cat(lses, 1)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    return _fwd_impl(q, k, v, causal, q_block, kv_block)[0]
