"""The SSD kernel's plain PyTorch versions: the Mamba-2 SSD (state-space
duality) operator [arXiv:2405.21060, §6], the torch counterpart of
``repro.kernels.ssd.ref``.

Recurrence (per batch row, per head; h ∈ R^{P×N}):
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t
Chunked form: within a chunk of length Q the output is a masked quadratic
(attention-like) product against the decay kernel L_ij = exp(cum_i − cum_j);
across chunks a small recurrence carries the (H, P, N) state. Where the
reference scans (``lax.scan``), these loop in Python over chunks or tokens.

All decay math runs in f32; A is negative and dt positive, so every exponent
is ≤ 0 (masked differences are zeroed before ``exp``).

B and C come as (B, S, N), one SSM group shared by every head, or as
(B, S, G, N), G groups: head h reads group h // (H / G) (the heads of a
group are consecutive). A grouped call is the one-group computation on
each group's heads, concatenated over the heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_F32 = torch.float32


def ssd_reference(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), already softplus'd, > 0
    a: torch.Tensor,  # (H,), negative
    b_mat: torch.Tensor,  # (B, S, N), one SSM group shared by the heads, or (B, S, G, N)
    c_mat: torch.Tensor,  # as b_mat
    chunk: int = 64,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) f32)."""
    if b_mat.dim() == 4:
        return _per_group(ssd_reference, x, dt, a, b_mat, c_mat, h0, chunk=chunk)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence length {s}")
    nc, q = s // chunk, chunk

    xf = x.to(_F32).reshape(bsz, nc, q, h, p)
    dtf = dt.to(_F32).reshape(bsz, nc, q, h)
    bf = b_mat.to(_F32).reshape(bsz, nc, q, n)
    cf = c_mat.to(_F32).reshape(bsz, nc, q, n)
    af = a.to(_F32)

    da = dtf * af  # (B, nc, Q, H), ≤ 0
    cum = torch.cumsum(da, dim=2)  # inclusive
    xdt = xf * dtf[..., None]  # (B, nc, Q, H, P)

    # ---- intra-chunk (diagonal blocks): masked decay attention ----------
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    diff = torch.where(mask, diff, 0.0)  # zero the masked (positive) diffs before exp
    decay = torch.where(mask, torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)  # (B, nc, Q, Q)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, xdt)

    # ---- chunk summaries -------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end, bf, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    # ---- inter-chunk recurrence ------------------------------------------
    h_state = torch.zeros((bsz, h, p, n), dtype=_F32, device=x.device) if h0 is None else h0.to(_F32)
    h_befores = []
    for c in range(nc):
        h_befores.append(h_state)  # the state *entering* chunk c
        h_state = h_state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(h_befores, 1)  # (B, nc, H, P, N)

    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", cf, torch.exp(cum), h_before)
    y = (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype)
    return y, h_state


def _per_group(fn, x, dt, a, b_mat, c_mat, h0, **kw):
    """``fn`` on each group's heads and its (B, S, N) B and C, the outputs
    concatenated over the heads."""
    h, g = x.shape[2], b_mat.shape[2]
    if g <= 0 or h % g or c_mat.shape != b_mat.shape:
        raise ValueError(f"{h} heads in {g} groups, B {tuple(b_mat.shape)}, C {tuple(c_mat.shape)}")
    hg = h // g
    outs = [fn(x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg], a[i * hg:(i + 1) * hg],
               b_mat[:, :, i], c_mat[:, :, i], h0=None if h0 is None else h0[:, i * hg:(i + 1) * hg], **kw)
            for i in range(g)]
    return torch.cat([y for y, _ in outs], 2), torch.cat([hf for _, hf in outs], 1)


def ssd_decode_step(
    h: torch.Tensor,  # (B, H, P, N) f32 state
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H), softplus'd
    a: torch.Tensor,  # (H,)
    b_vec: torch.Tensor,  # (B, N), or (B, G, N) for G groups
    c_vec: torch.Tensor,  # as b_vec
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update (the serving path). Returns (y (B, H, P)
    in x's dtype, the new state f32)."""
    # each head reads its group's B and C; one group keeps the formula below,
    # since this one sums y in another order and moves its bits
    if b_vec.dim() == 3:
        hg = x.shape[1] // b_vec.shape[1]
        b_h, c_h = (t.to(_F32).repeat_interleave(hg, 1) for t in (b_vec, c_vec))  # (B, H, N)
        dtf = dt.to(_F32)
        h_new = h * torch.exp(dtf * a.to(_F32))[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf, x.to(_F32), b_h)
        return torch.einsum("bhpn,bhn->bhp", h_new, c_h).to(x.dtype), h_new
    dtf = dt.to(_F32)
    da = torch.exp(dtf * a.to(_F32))  # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, x.to(_F32), b_vec.to(_F32))
    h_new = h * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c_vec.to(_F32))
    return y.to(x.dtype), h_new


def ssd_naive(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence: the ground truth the chunked form must
    match (one group or G, as :func:`ssd_reference`)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    h_state = torch.zeros((bsz, h, p, n), dtype=_F32, device=x.device) if h0 is None else h0.to(_F32)
    ys = []
    for t in range(s):
        y, h_state = ssd_decode_step(h_state, x[:, t], dt[:, t], a, b_mat[:, t], c_mat[:, t])
        ys.append(y)
    return torch.stack(ys, 1).to(x.dtype), h_state
