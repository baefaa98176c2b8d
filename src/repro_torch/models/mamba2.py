"""Mamba-2 block [arXiv:2405.21060]: in_proj → short causal depthwise conv →
SSD sequence transform → gated RMSNorm → out_proj; the torch counterpart of
``repro.models.mamba2``, with its rounding points (the conv and SiLU output
in the input dtype, softplus and the gate's SiLU in f32, the gated product
in y's dtype before the norm).

The sequence path takes the chunked SSD as ``ssd_fn`` (``kernels.ssd``: the
CUDA kernel on the card, the plain version elsewhere) and the gated norm as
``norm_fn`` (``kernels.rmsnorm`` or ``layers.rms_norm``); the decode path
keeps a recurrent (conv window, SSM state) cache per layer, O(1) per token,
and updates it in place.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels.ssd.ref import ssd_decode_step, ssd_reference
from ..sharding.act import constrain, on_shards, use_weight
from .layers import _mm, rms_norm

_F32 = torch.float32


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_d_inner
    nh = cfg.ssm_n_heads
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n  # x, B, C all pass through the conv
    return d_in, nh, n, conv_dim


def mamba2_init(normal: Callable, cfg: ModelConfig, dtype, device) -> dict:
    """One block's parameters with the reference's distributions; ``normal``
    draws a seeded f32 normal of a shape times a scale, cast to ``dtype``.
    The SSM scalars (``a_log``, ``d_skip``, ``dt_bias``) are f32 whatever
    ``dtype`` is, as in the reference."""
    d = cfg.d_model
    d_in, nh, n, conv_dim = _dims(cfg)
    # in_proj emits [z (d_in), xBC (conv_dim), dt (nh)]
    return {
        "in_proj": normal((d, 2 * d_in + 2 * n + nh), 1.0 / math.sqrt(d)),
        "conv_w": normal((cfg.ssm_conv_width, conv_dim), 0.1),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=_F32, device=device)),
        "d_skip": torch.ones(nh, dtype=_F32, device=device),
        "dt_bias": torch.zeros(nh, dtype=_F32, device=device),
        "norm": torch.zeros(d_in, dtype=dtype, device=device),
        "out_proj": normal((d_in, d), 1.0 / math.sqrt(d_in)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's ``softplus``
    switches to the identity above ``threshold=20`` (a difference below
    3e-9), so the port writes it as the reference does."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W: y_t = Σ_w x_{t-W+1+w} · w_w + b, as W
    shifted adds in the input dtype. xbc: (B, S, C). A DTensor runs on
    each device's shards (:func:`_conv_on_shards`)."""
    if isinstance(xbc, DTensor):
        return _conv_on_shards(xbc, w, b)
    width, s = w.shape[0], xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(width):
        shift = width - 1 - i
        shifted = xbc if shift == 0 else F.pad(xbc, (0, 0, shift, 0))[:, :s]
        out = out + shifted * w[i]
    return out + b


def _conv_on_shards(xbc: DTensor, w: torch.Tensor, b: torch.Tensor) -> DTensor:
    """:func:`_causal_conv` on each device's shards: the sequence whole
    (the conv runs along it), the batch as xbc has it, the channels split
    where the weight splits them. DTensor's own ``pad`` along a whole dim
    fails on torch 2.11 (an index error in its redistribution planner)."""
    whole = [Replicate()] * xbc.device_mesh.ndim
    x_pl, w_pl, b_pl = [], [], []
    for px, pw in zip(xbc.placements, getattr(w, "placements", whole)):
        split = pw == Shard(1)  # the weight's channels over this mesh dim
        x_pl.append(Shard(2) if split else px if px == Shard(0) else Replicate())
        w_pl.append(Shard(1) if split else Replicate())
        b_pl.append(Shard(0) if split else Replicate())
    return on_shards(_causal_conv, (xbc, w, b), (x_pl, w_pl, b_pl), [x_pl], work=x_pl)


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, nh, n, conv_dim = _dims(cfg)
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim], zxbcdt[..., d_in + conv_dim:]


def _gated_out(params: dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig, norm_fn: Callable) -> torch.Tensor:
    """D skip, gate by SiLU(z), RMSNorm, out_proj: y and xs (B, S, H, P) or
    (B, H, P) → (B, S or 1, D)."""
    y = y + params["d_skip"][:, None] * xs  # the skip broadcasts over (H, P)
    y = y.reshape(y.shape[0], -1, cfg.ssm_d_inner)
    y = norm_fn(y * F.silu(z.to(_F32)).to(y.dtype), params["norm"], cfg.norm_eps)
    return _mm("bse,ed->bsd", y, use_weight(params["out_proj"]))


def mamba2_prefill(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    ssd_fn: Optional[Callable] = None,
    norm_fn: Callable = rms_norm,
) -> Tuple[torch.Tensor, dict]:
    """The sequence path and the decode cache it leaves: (out (B, S, D),
    {"conv": the last W-1 raw conv inputs (B, W-1, conv_dim), "ssm": the
    final SSM state (B, H, P, N) f32}).

    The reference builds that cache in ``models/model.py``
    ``_mamba_prefill_cache``, which runs in_proj, the conv and the SSD a
    second time only to get the final state; here it is the ``h_final`` of
    the one SSD call (the CUDA kernel emits it), so the SSD runs once per
    layer per prefill. A prompt shorter than W-1 tokens is zero-padded on
    the left, as the causal conv pads it."""
    d_in, nh, n, conv_dim = _dims(cfg)
    b, s, _ = x.shape
    zxbcdt = _mm("bsd,de->bse", x, use_weight(params["in_proj"]))
    z, xbc_raw, dt = _split(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]).to(_F32)).to(x.dtype)
    xs = xbc[..., :d_in].reshape(b, s, nh, cfg.ssm_head_dim)
    b_mat = xbc[..., d_in:d_in + n]
    c_mat = xbc[..., d_in + n:]
    dt = _softplus(dt.to(_F32) + params["dt_bias"])  # (B, S, nh)
    a = -torch.exp(params["a_log"])  # (nh,) < 0
    # on a mesh the SSD's heads split over the model axis (the ssm_heads
    # rule), so the model-axis devices share the scan
    xs, dt = constrain(xs, ("batch", "seq", "ssm_heads", None)), constrain(dt, ("batch", "seq", "ssm_heads"))
    y, h_final = (ssd_fn or ssd_reference)(xs, dt, a, b_mat, c_mat)
    out = _gated_out(params, y, xs, z, cfg, norm_fn)
    w = cfg.ssm_conv_width
    window = xbc_raw if s >= w - 1 else F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
    conv = window[:, window.shape[1] - (w - 1):].contiguous()  # a copy, not a view of zxbcdt
    return out, {"conv": conv, "ssm": h_final}


def mamba2_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    ssd_fn: Optional[Callable] = None,
    norm_fn: Callable = rms_norm,
) -> torch.Tensor:
    """The reference's ``mamba2_apply``: the block's output (B, S, D)."""
    return mamba2_prefill(params, x, cfg, ssd_fn, norm_fn)[0]


# ---------------------------------------------------------------------------
# decode path: recurrent cache = (conv window, ssm state)
# ---------------------------------------------------------------------------
def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_in, nh, n, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=_F32, device=device),
    }


def mamba2_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,
    cfg: ModelConfig,
    norm_fn: Callable = rms_norm,
) -> Tuple[torch.Tensor, dict]:
    """One token: (out (B, 1, D), cache). The cache is updated IN PLACE (the
    reference returns a new one) and returned: the conv window shifts by one
    token in the cache's dtype, which should be the compute dtype (the
    reference's concatenation would promote a bf16 window under f32
    compute), and the SSM state is overwritten."""
    d_in, nh, n, conv_dim = _dims(cfg)
    b = x.shape[0]
    zxbcdt = _mm("bsd,de->bse", x, use_weight(params["in_proj"]))
    z, xbc, dt = _split(cfg, zxbcdt)  # xbc: (B, 1, conv_dim)

    window = torch.cat([cache["conv"], xbc], 1)  # (B, W, conv_dim)
    conv_out = _mm("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"]
    xbc_t = F.silu(conv_out.to(_F32)).to(x.dtype)  # (B, conv_dim)

    xs = xbc_t[:, :d_in].reshape(b, nh, cfg.ssm_head_dim)
    b_vec = xbc_t[:, d_in:d_in + n]
    c_vec = xbc_t[:, d_in + n:]
    dt_t = _softplus(dt[:, 0].to(_F32) + params["dt_bias"])  # (B, nh)
    a = -torch.exp(params["a_log"])

    y, h_new = ssd_decode_step(cache["ssm"], xs, dt_t, a, b_vec, c_vec)
    out = _gated_out(params, y, xs, z, cfg, norm_fn)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(h_new)
    return out, cache
