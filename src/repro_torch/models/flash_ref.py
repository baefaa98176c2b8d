"""Blockwise causal GQA attention with a FlashAttention-style backward
[arXiv:2205.14135, 2307.08691], in plain torch: the torch counterpart of
``repro.models.flash_ref``.

Layout: q (B, Sq, H, Dh); k, v (B, Skv, K, Dh); GQA via grouped reshape.
Forward math in f32 online softmax; the output keeps q's dtype, the row
log-sum-exp is f32. This is what ``attn_impl="blockwise"`` runs (and
``"auto"`` beyond 1024 tokens). The reference's ``custom_vjp`` is
:class:`FlashAttentionRef`, a ``torch.autograd.Function``: its forward saves
only (q, k, v, out, lse) and its backward (:func:`_bwd_impl`) recomputes the
score blocks, so no (S, S) probability tensor outlives the forward. The
flash kernel's wrapper (``kernels.flash_attention.ops``) trains through the
same backward.
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


def _bwd_impl(q, k, v, out, lse, dout, causal: bool, q_block: int, kv_block: int):
    """The flash backward: (dq, dk, dv) in the dtypes of (q, k, v), from
    the saved (out, lse (B, Sq, K, G) f32) and the output's gradient. KV
    blocks outer, query blocks inner, every product and sum in f32, as the
    reference's ``_bwd_impl``. A query block that lies wholly above a KV
    block's causal diagonal contributes exact zeros there, so it is skipped
    (the reference computes and masks it)."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide ({sq}, {skv})")
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    # D_i = rowsum(dout * out)  (B, Sq, K, G)
    delta = (dout.to(_F32) * out.to(_F32)).sum(-1).reshape(b, sq, kh, g)
    qf = q.reshape(b, sq, kh, g, dh).to(_F32)
    dof = dout.reshape(b, sq, kh, g, dh).to(_F32)
    dq = torch.zeros((b, sq, kh, g, dh), dtype=_F32, device=dev)
    dk = torch.zeros((b, skv, kh, dh), dtype=_F32, device=dev)
    dv = torch.zeros((b, skv, kh, dh), dtype=_F32, device=dev)
    for jk in range(skv // kv_block):
        sl = slice(jk * kv_block, (jk + 1) * kv_block)
        kj, vj = k[:, sl].to(_F32), v[:, sl].to(_F32)
        cols = jk * kv_block + torch.arange(kv_block, device=dev)
        dk_j = torch.zeros((b, kv_block, kh, dh), dtype=_F32, device=dev)
        dv_j = torch.zeros((b, kv_block, kh, dh), dtype=_F32, device=dev)
        for iq in range(sq // q_block):
            if causal and (iq + 1) * q_block - 1 < jk * kv_block:
                continue  # every (row, col) of the pair is masked: p = 0
            rs = slice(iq * q_block, (iq + 1) * q_block)
            qi, doi = qf[:, rs], dof[:, rs]
            rows = iq * q_block + torch.arange(q_block, device=dev)
            s_blk = torch.einsum("bqkgd,bskd->bkgqs", qi, kj) * scale
            if causal:
                s_blk = torch.where(rows[:, None] >= cols[None, :], s_blk, NEG_INF)
            # p = exp(s - lse)
            p = torch.exp(s_blk - lse[:, rs].permute(0, 2, 3, 1)[..., None])
            dv_j = dv_j + torch.einsum("bkgqs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doi, vj)
            ds = p * (dp - delta[:, rs].permute(0, 2, 3, 1)[..., None]) * scale
            dk_j = dk_j + torch.einsum("bkgqs,bqkgd->bskd", ds, qi)
            dq[:, rs] += torch.einsum("bkgqs,bskd->bqkgd", ds, kj)
        dk[:, sl], dv[:, sl] = dk_j, dv_j
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttentionRef(torch.autograd.Function):
    """The reference's ``custom_vjp``: forward :func:`_fwd_impl`, saving
    (q, k, v, out, lse); backward :func:`_bwd_impl` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_block: int, kv_block: int):
        out, lse = _fwd_impl(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd_impl(*ctx.saved_tensors, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blockwise attention (B, Sq, H, Dh) in q's dtype; differentiable
    through :class:`FlashAttentionRef` where an input needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionRef.apply(q, k, v, causal, q_block, kv_block)
    return _fwd_impl(q, k, v, causal, q_block, kv_block)[0]
