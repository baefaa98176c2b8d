"""Core layers: RMSNorm, RoPE / M-RoPE, GQA attention (full, blockwise
flash-style, and decode), SwiGLU/GeGLU/GELU MLPs.

The torch counterpart of ``repro.models.layers``, with its rounding points:
activations (batch, seq, ...) in the compute dtype; normalization
statistics, rotary math and attention logits/softmax in f32, each cast back
exactly where the reference casts. Attention tensors are (B, S, H, head_dim);
GQA groups query heads over KV heads by a reshape (KV is never repeated).

Where the reference mixes dtypes in one product (an f32 compute path reading
a bf16 cache) JAX promotes both operands; :func:`_mm` does the same, since
torch refuses mixed-dtype products.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..sharding.act import on_shards, shard_index, use_weight
from .flash_ref import _fwd_impl

NEG_INF = -1e30  # finite, as the reference's: exp(NEG_INF - m) underflows to 0

_F32 = torch.float32


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's dtype promotion (bf16 with f32 gives f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(_F32))).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., Dh) with cos/sin broadcastable to (..., Dh/2)."""
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer."""
    inv = rope_inv_freq(x.shape[-1], theta, x.device)  # (Dh/2,)
    ang = positions.to(_F32)[..., None] * inv  # (B, S, Dh/2)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: Tuple[int, ...]
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the Dh/2 frequency slots are split into
    temporal/height/width ``sections``; each section rotates by its own
    position stream. x: (B, S, H, Dh); positions: (3, B, S) integer."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover head_dim/2 = {dh // 2}")
    inv = rope_inv_freq(dh, theta, x.device)
    ang_all = positions.to(_F32)[..., None] * inv  # (3, B, S, Dh/2)
    pieces, start = [], 0
    for axis, sec in enumerate(sections):
        pieces.append(ang_all[axis, :, :, start:start + sec])
        start += sec
    ang = torch.cat(pieces, -1)  # (B, S, Dh/2)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, K, G, Dh) grouped query; k: (B, Skv, K, Dh) →
    scores (B, K, G, Sq, Skv), f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(_F32), k.to(_F32))


def attention_full(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0
) -> torch.Tensor:
    """Reference attention (materializes S² scores). q: (B, Sq, H, Dh);
    k, v: (B, Skv, K, Dh); returns (B, Sq, H, Dh). The probabilities are
    cast to ``v``'s dtype before the PV product, as the reference does."""
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    scores = _gqa_scores(q.reshape(b, sq, kheads, h // kheads, dh), k) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, NEG_INF)
    probs = torch.softmax(scores, -1)
    out = _mm("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def attention_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_block: int = 512,
    kv_block: int = 1024,
    causal: bool = True,
) -> torch.Tensor:
    """FlashAttention-style blockwise attention in plain torch: online
    softmax over kv blocks, looped over q blocks; the live score tensor is
    (B, K, G, q_block, kv_block). Fully masked kv blocks still compute and
    are then masked, as in the reference. The same arithmetic as the
    forward of :func:`~repro_torch.models.flash_ref.flash_attention_ref`."""
    return _fwd_impl(q, k, v, causal, q_block, kv_block)[0]


def attention_decode(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_index: int
) -> torch.Tensor:
    """One-token decode against a (B, S, K, Dh) KV cache; positions strictly
    after ``cur_index`` are masked. q: (B, 1, H, Dh). A DTensor cache (a
    mesh) runs on each device's shards (:func:`_decode_on_shards`)."""
    if isinstance(k_cache, DTensor):
        return _decode_on_shards(q, k_cache, v_cache, cur_index)
    return _decode(q, k_cache, v_cache, cur_index, 1.0 / math.sqrt(q.shape[-1]))


def _decode(q, k_cache, v_cache, cur_index: int, scale: float, s_offset: int = 0,
            dh_groups=(), seq_groups=()) -> torch.Tensor:
    """:func:`attention_decode` on one device's shards: the partial scores of
    a head dim split over ``dh_groups`` summed over them (the reference's
    split-contraction decode), a sequence split over ``seq_groups`` (this
    shard's positions from ``s_offset``) softmaxed over all of it, the
    probabilities rounded to the cache's dtype as on one device."""
    b, _, h, dh = q.shape
    kheads = k_cache.shape[2]
    scores = _gqa_scores(q.reshape(b, 1, kheads, h // kheads, dh), k_cache)
    for g in dh_groups:
        scores = funcol.all_reduce(scores, "sum", g)
    scores = scores * scale
    valid = s_offset + torch.arange(k_cache.shape[1], device=q.device) <= cur_index  # (S,)
    scores = torch.where(valid, scores, NEG_INF)
    if not seq_groups:
        probs = torch.softmax(scores, -1)
        out = _mm("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype), v_cache)
        return out.reshape(b, 1, h, dh)
    m = scores.amax(-1, keepdim=True)
    for g in seq_groups:
        m = funcol.all_reduce(m, "max", g)
    p = torch.exp(scores - m)
    total = p.sum(-1, keepdim=True)
    for g in seq_groups:
        total = funcol.all_reduce(total, "sum", g)
    probs = (p / total).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(_F32), v_cache.to(_F32))
    for g in seq_groups:
        out = funcol.all_reduce(out, "sum", g)
    return out.to(v_cache.dtype).reshape(b, 1, h, dh)


def _decode_on_shards(q, k_cache: DTensor, v_cache: DTensor, cur_index: int) -> DTensor:
    """Decode attention where the cache is placed: each device attends with
    its cache shard as it lies (a whole-cache gather per step would move
    the cache), q taking the cache's layout. Per mesh dim the cache shards
    the batch (q and the output alike), the KV heads (q and the output on
    their query heads), the head dim (q and the output alike; the scores
    summed over the dim's devices) or the sequence (q whole; the softmax
    and the output reduced over the dim's devices)."""
    mesh = k_cache.device_mesh
    q_pl, out_pl, dh_groups, seq_dims = [], [], [], []
    for i, p in enumerate(k_cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            seq_dims.append(i)
            p = Replicate()
        elif isinstance(p, Shard) and p.dim == 3:
            dh_groups.append((mesh, i))
        elif not isinstance(p, Shard):
            p = Replicate()
        q_pl.append(p)
        out_pl.append(p)
    chunk = shard_index(mesh, seq_dims)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def local(ql, kl, vl):
        return _decode(ql, kl, vl, cur_index, scale, chunk * kl.shape[1], dh_groups,
                       [(mesh, i) for i in seq_dims])

    kv_pl = tuple(k_cache.placements)
    return on_shards(local, (q, k_cache, v_cache), (tuple(q_pl), kv_pl, kv_pl), [tuple(out_pl)],
                     work=tuple(out_pl))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU / GeGLU gated MLP, or plain GELU FFN, or the non-gated relu²
    MLP ``down(relu(x up)²)`` (``wi_up``, ``wo``): (B, S, D) → (B, S, D).
    The activation runs in f32 and is cast back to x's dtype."""
    if kind == "relu2":
        up = _mm("bsd,df->bsf", x, use_weight(params["wi_up"]))
        act = F.relu(up.to(_F32)).square().to(x.dtype)
        return _mm("bsf,fd->bsd", act, use_weight(params["wo"]))
    gate = _mm("bsd,df->bsf", x, use_weight(params["wi_gate"]))
    if kind == "swiglu":
        act = F.silu(gate.to(_F32)).to(x.dtype)
    elif kind in ("geglu", "gelu"):
        act = F.gelu(gate.to(_F32), approximate="tanh").to(x.dtype)
    else:
        raise KeyError(kind)
    if kind != "gelu":  # gated variants multiply by the up projection
        act = act * _mm("bsd,df->bsf", x, use_weight(params["wi_up"]))
    return _mm("bsf,fd->bsd", act, use_weight(params["wo"]))
