"""Plain float32 reference of the Nemotron-H hybrid decoder (NVIDIA Nemotron 3
Nano 30B-A3B), written from the published architecture (``nemotron_h``), in
plain torch: no kernel, no cache, nothing of the port imported.

Every layer is one mixer with its own RMSNorm and residual, x += Mixer(RMSNorm(x)),
the mixer given by the layer's letter of the pattern:

  * M, Mamba-2: in_proj to [z (d_inner), xBC (d_inner + 2 G N), dt (H)]; a
    causal depthwise conv of width W with bias over xBC, then SiLU; x split
    into H heads of P, B and C into G groups of N (head h reads group
    h // (H / G)); dt = softplus(dt + dt_bias), A = -exp(a_log); the SSD
    recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = C_t · h_t,
    worked chunk by chunk (the quadratic form inside a chunk, the state
    carried between chunks); y += D x; y · SiLU(z) normed over each group's
    d_inner / G channels; out_proj;
  * E, MoE: an f32 router, sigmoid scores; each token's top k of score +
    ``e_score_correction_bias`` (``router_bias``) chosen; the gates its raw
    scores renormalised over the k, times ``routed_scaling_factor``; each
    expert down(relu(up x)²); one shared expert of the same form on every
    token, added;
  * *, attention: GQA, causal softmax over QKᵀ/√Dh, no positional encoding.

The final RMSNorm feeds the untied ``lm_head``. RMSNorm scales are applied
as (1 + w), the parametrisation of the weights the benchmark draws.

Departure from the release, stated by the configuration (``assumed``): a MoE
layer keeps a static capacity of C = ⌈T·k·capacity_factor/E⌉ rows an expert
(at least k, at most T); the assignments to an expert are ranked token-major
(earlier tokens first), and those ranked C or later are dropped.

``follow`` lets the check hold this reference to a program's routing where
the two differ at a near-tie: per MoE layer the program's expert choice
(T, k) and its kept assignments. A token whose expert set differs from the
reference's takes the program's set where the reference's own margin (its
k-th choice score less its (k+1)-th) is under ``near``; elsewhere the
reference keeps its own, and the disagreement is a miss. Each layer's
:func:`routing_stats` report what was forced and what missed.

``fp8=True`` is the control: every product the configuration computes in
bf16 (projections, the SSD's operands, QKᵀ and PV, the experts, the head)
takes its operands rounded to float8 e4m3 with one scale a tensor
(amax / 448); the router stays f32, as stated.

It works in blocks, so that it runs on the card beside the bf16 model: one
expert's matrices upcast at a time, attention a block of query rows at a
time, the SSD a chunk at a time. Matrix products run in full f32:
``reference_precision()`` turns TF32 off for the duration.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0
Q_CHUNK = 512  # query rows an attention block holds
SSD_CHUNK = 128  # tokens an SSD block holds


@contextlib.contextmanager
def reference_precision():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
        torch.set_float32_matmul_precision(prec)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (its amax / 448), in f32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def q8(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return fake_fp8(x) if fp8 else x


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return torch.matmul(q8(a, fp8), q8(b.to(F32), fp8))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.to(F32))


def relu2_mlp(x, up, down, fp8: bool) -> torch.Tensor:
    return mm(F.relu(mm(x, up, fp8)).square(), down, fp8)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: out_t = Σ_i w_i x_{t-W+1+i} + b; x (B, S, C),
    w (W, C); earlier positions than the first are zero."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = bias.to(F32).expand_as(x).clone()
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i].to(F32)
    return out


def ssd(x, dt, a, bm, cm, fp8: bool) -> torch.Tensor:
    """y (B, S, H, P) of the SSD recurrence (module docstring), a chunk of
    ``SSD_CHUNK`` tokens at a time: inside a chunk y_i = Σ_{j<=i} (C_i·B_j)
    exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i · h, then h is carried to
    the chunk's end. x (B, S, H, P); dt (B, S, H); a (H,); bm, cm (B, S, G, N)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = h // g
    x, bm, cm = q8(x, fp8), q8(bm, fp8), q8(cm, fp8)
    state = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, s, SSD_CHUNK):
        c1 = min(c0 + SSD_CHUNK, s)
        q = c1 - c0
        xc, dtc = x[:, c0:c1], dt[:, c0:c1]
        bc = bm[:, c0:c1].repeat_interleave(hg, 2)  # (B, Q, H, N)
        cc = cm[:, c0:c1].repeat_interleave(hg, 2)
        cum = torch.cumsum(dtc * a, 1)  # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Qi, Qj, H)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
        decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        cb = torch.einsum("bihn,bjhn->bijh", cc, bc)
        y = torch.einsum("bijh,bjh,bjhp->bihp", cb * decay, dtc, xc)
        y = y + torch.einsum("bihn,bhpn->bihp", cc, state) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum) * dtc  # (B, Q, H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bjh,bjhn,bjhp->bhpn", to_end, bc, xc)
        ys.append(y)
    return torch.cat(ys, 1)


def mamba_mixer(x: torch.Tensor, p: Dict, cfg, fp8: bool) -> torch.Tensor:
    b, s, _ = x.shape
    h, hp, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    d_in = h * hp
    zxbcdt = mm(x, p["in_proj"], fp8)
    z, xbc, dt = zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * g * n], zxbcdt[..., 2 * d_in + 2 * g * n:]
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(b, s, h, hp)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    y = ssd(xs, dt, a, bm, cm, fp8) + p["d_skip"].to(F32)[:, None] * xs
    y = (y.reshape(b, s, d_in) * F.silu(z)).reshape(b, s, g, d_in // g)
    y = rms_norm(y, p["norm"].reshape(g, d_in // g), cfg.norm_eps).reshape(b, s, d_in)
    return mm(y, p["out_proj"], fp8)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention(q, k, v, fp8: bool) -> torch.Tensor:
    """Causal GQA. q (B, S, H, Dh); k, v (B, S, KH, Dh) → (B, S, H, Dh),
    a block of query rows at a time."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh).permute(0, 2, 3, 1, 4)  # (B, KH, G, S, Dh)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, KH, 1, Dh, S)
    vg = v.permute(0, 2, 1, 3)[:, :, None]  # (B, KH, 1, S, Dh)
    outs = []
    for r0 in range(0, s, Q_CHUNK):
        r1 = min(r0 + Q_CHUNK, s)
        rows, cols = torch.arange(r0, r1, device=q.device), torch.arange(r1, device=q.device)
        scores = mm(qg[:, :, :, r0:r1], kt[..., :r1], fp8) / math.sqrt(dh)
        scores = scores.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        outs.append(mm(torch.softmax(scores, -1), vg[..., :r1, :], fp8))
    return torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def attention_mixer(x: torch.Tensor, p: Dict, cfg, fp8: bool) -> torch.Tensor:
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, p["wq"], fp8).reshape(b, s, h, dh)
    k = mm(x, p["wk"], fp8).reshape(b, s, kh, dh)
    v = mm(x, p["wv"], fp8).reshape(b, s, kh, dh)
    return mm(attention(q, k, v, fp8).reshape(b, s, h * dh), p["wo"], fp8)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def capacity(t: int, cfg) -> int:
    c = math.ceil(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, min(c, t))


def ranks(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each flat assignment's place in its expert's queue, token-major."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(flat_e.numel(), device=flat_e.device) - starts[flat_e[order]]
    return rank


def moe(x: torch.Tensor, p: Dict, cfg, fp8: bool, stats: Optional[List] = None, last_only: bool = False,
        follow: Optional[dict] = None, near: float = 0.0) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): routing (module docstring; ``follow``: the
    program's ``{"expert_idx", "keep"}`` of this layer), static capacity,
    each expert on its kept tokens, the gate-weighted sum, the shared
    expert. ``last_only`` computes the routed experts for each sequence's
    last token alone. ``stats`` receives this layer's :func:`routing_stats`."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    xf = x.reshape(t, d)
    scores = torch.sigmoid(xf @ p["router"].to(F32))
    choice = scores + p["router_bias"].to(F32)
    top = torch.topk(choice, k + 1, dim=-1)
    idx, margin = top.indices[:, :k], top.values[:, k - 1] - top.values[:, k]
    differ = forced = torch.zeros(t, dtype=torch.bool, device=x.device)
    if follow is not None:
        theirs = follow["expert_idx"].reshape(t, k)
        differ = (idx.sort(-1).values != theirs.sort(-1).values).any(-1)
        forced = differ & (margin < near)
        idx = torch.where(forced[:, None], theirs, idx)
    gates = scores.gather(-1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * cfg.moe_routed_scale
    flat_e = idx.reshape(-1)
    rank = ranks(flat_e, e)
    cap = capacity(t, cfg)
    keep = rank < cap
    if stats is not None:
        stats.append(routing_stats(choice, idx, margin, rank, keep, cap, differ, forced, follow, b, s, k))
    kept = torch.nonzero(keep).reshape(-1)
    if last_only:
        kept = kept[(kept // k) % s == s - 1]
    kept = kept[torch.argsort(flat_e[kept], stable=True)]  # by expert
    per_expert = torch.bincount(flat_e[kept], minlength=e).tolist()
    token = kept // k
    y = torch.zeros_like(xf)
    start = 0
    for ex, cnt in enumerate(per_expert):
        if cnt:
            sel = slice(start, start + cnt)
            hx = relu2_mlp(xf[token[sel]], p["wi_up"][ex], p["wo"][ex], fp8)
            y = y.index_add(0, token[sel], hx * gates.reshape(-1)[kept[sel], None])
        start += cnt
    sh = p["shared"]
    return y.reshape(b, s, d) + relu2_mlp(x, sh["wi_up"], sh["wo"], fp8)


def routing_stats(choice, idx, margin, rank, keep, cap: int, differ, forced, follow, b: int, s: int,
                  k: int) -> Dict[str, object]:
    """One MoE layer's routing as this reference computed it: the share of
    assignments dropped; for each sequence's last token its ``margin`` (k-th
    choice score less the (k+1)-th) and ``boundary`` (the fewest
    assignments to one of its experts, ahead of it, that would turn one of
    its assignments from kept to dropped or back); and, where it followed a
    program: ``tokens``, the layer's tokens; ``departs``, the tokens whose
    expert set differed from the program's (forced or not); ``forced``, the
    tokens that took the program's experts at a near-tie,
    ``forced_margin_max``, the widest margin among all tokens
    whose expert set differed (forced or not), ``set_misses``, the
    assignments of the program that this reference did not make at tokens
    it did not force, and ``keep_misses``, the assignments both made whose
    kept or dropped state differs."""
    last = torch.arange(b, device=choice.device) * s + s - 1
    r = rank.reshape(-1, k)[last]
    boundary = torch.where(r < cap, cap - r, r - cap + 1).amin(-1)
    out = {"drop_share": 1.0 - keep.float().mean().item(), "margin": margin[last].tolist(),
           "boundary": boundary.tolist(), "route": {"expert_idx": idx, "keep": keep.reshape(-1, k)}}
    if follow is not None:
        theirs = follow["expert_idx"].reshape(-1, k)
        missed = differ & ~forced
        mine = torch.zeros_like(choice, dtype=torch.bool).scatter_(1, idx, True)
        set_misses = (~mine.gather(1, theirs) & missed[:, None]).sum()
        mine_keep = torch.zeros_like(choice, dtype=torch.int8).scatter_(1, idx, keep.reshape(-1, k).to(torch.int8))
        their_keep = torch.zeros_like(choice, dtype=torch.int8).scatter_(
            1, theirs, follow["keep"].reshape(-1, k).to(torch.int8))
        both = mine & torch.zeros_like(mine).scatter_(1, theirs, True)
        out.update(tokens=choice.shape[0], departs=int(differ.sum()), forced=int(forced.sum()),
                   set_misses=int(set_misses),
                   keep_misses=int((both & (mine_keep != their_keep)).sum()),
                   forced_margin_max=float(margin[differ].max()) if bool(differ.any()) else 0.0)
    return out


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def layer(x: torch.Tensor, p: Dict, cfg, pos: int, fp8: bool, stats: Optional[List] = None,
          last_only: bool = False, follow: Optional[dict] = None, near: float = 0.0) -> torch.Tensor:
    kind = cfg.block_kinds[pos % len(cfg.block_kinds)]
    if kind == "mamba":
        return x + mamba_mixer(rms_norm(x, p["norm1"], cfg.norm_eps), p["mixer"], cfg, fp8)
    if kind == "attn":
        return x + attention_mixer(rms_norm(x, p["norm1"], cfg.norm_eps), p["mixer"], cfg, fp8)
    return x + moe(rms_norm(x, p["norm2"], cfg.norm_eps), p["mlp"], cfg, fp8, stats, last_only, follow, near)


def hidden(w: Dict, cfg, tokens: torch.Tensor, fp8: bool = False, stats: Optional[List] = None,
           last_only: bool = False, follow: Optional[Sequence[dict]] = None, near: float = 0.0) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) in f32. ``last_only``: only
    each sequence's last position comes out right (a last MoE layer's
    routed experts run for it alone). ``stats`` receives each MoE layer's
    routing, in order; ``follow``: the program's routing, one entry a MoE
    layer in order (module docstring)."""
    x = w["embed"][tokens].to(F32)
    n = len(w["layers"])
    moe_i = 0
    for i, p in enumerate(w["layers"]):
        theirs = None
        if cfg.mlp_kinds[i % len(cfg.mlp_kinds)] == "moe":
            theirs = follow[moe_i] if follow is not None else None
            moe_i += 1
        x = layer(x, p, cfg, i, fp8, stats, last_only and i == n - 1, theirs, near)
    return rms_norm(x, w["final_norm"], cfg.norm_eps)


def last_logits(w: Dict, cfg, tokens: torch.Tensor, fp8: bool = False, stats: Optional[List] = None,
                follow: Optional[Sequence[dict]] = None, near: float = 0.0) -> torch.Tensor:
    """The logits (B, V) at each sequence's last position; ``stats``
    receives each MoE layer's routing (:func:`routing_stats`)."""
    with torch.no_grad():
        h = hidden(w, cfg, tokens, fp8, stats, last_only=True, follow=follow, near=near)[:, -1]
        return mm(h, w["lm_head"], fp8)
