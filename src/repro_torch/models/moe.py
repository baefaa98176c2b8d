"""Mixture-of-Experts layer: top-k routing with static-capacity dispatch;
the torch counterpart of ``repro.models.moe``.

Dispatch is the reference's deterministic position-in-expert construction:
a token-major one-hot cumsum over the flat (token, k) assignments gives each
assignment its place in its expert's queue, and assignments at or past the
static capacity ``C`` are dropped (capacity-factor semantics). Tokens keep
their top-k gates renormalised over the k chosen experts; a dropped
assignment contributes nothing. Every shape comes from the input's shape and
the config (``capacity`` is a Python int), and no step reads a device value
on the host: the layer runs without a host synchronisation.

The expert MLPs are three batched products over the (E, C, D) dispatch
buffer, the reference's grouped einsums (outside any Pallas kernel there),
so they run as ``torch.bmm``.

Under a mesh context (``sharding.act.activation_rules``) the reference's
four ``constrain`` points pin the flat (T·k, D) dispatch rows to
``moe_flat`` and the (E, C, D) buffer and expert outputs to the
expert-parallel layout. The routing and the dispatch index over the
*global* flat axis, which no placement shards, so three places run on
tensors gathered whole on every device (``sharding.act.gathered``), as the
reference's GSPMD all-gathers there (``models.moe_shard_map`` is the path
that avoids it):

  1. the flat expert ids before the position cumsum and the aux count
     (a cumsum over a sharded token axis would restart on every shard);
  2. the dispatch rows before the ``index_add`` into the buffer (its slots
     are global rows);
  3. the expert outputs before the combine gather (``h[slot]``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.act import constrain, flatten, gathered, unflatten
from .layers import _mm

_F32 = torch.float32

# the routing of every ``moe_apply`` call inside ``record_routing()``
_RECORD: Optional[List[dict]] = None


def moe_init(normal: Callable, cfg: ModelConfig, dtype, device) -> dict:
    """One layer's parameters with the reference's distributions: ``normal``
    draws a seeded f32 normal of a shape times a scale, cast to its ``dt``
    argument (``dtype`` here). The router is (D, E) and f32 whatever
    ``dtype`` is; the experts are ``wi_gate``/``wi_up`` (E, D, F) × 1/√D and
    ``wo`` (E, F, D) × 1/√F, one tensor drawn at a time."""
    del device  # drawn where ``normal`` draws
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": normal((d, e), s_in, dt=_F32),
        "wi_gate": normal((e, d, f), s_in, dt=dtype),
        "wi_up": normal((e, d, f), s_in, dt=dtype),
        "wo": normal((e, f, d), s_out, dt=dtype),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert: ⌈T·k·factor/E⌉, at least k and at most T."""
    c = math.ceil(  # repro_torch: noqa[f64-promote]: Python numbers, so a static capacity
        n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, min(c, n_tokens))


@contextlib.contextmanager
def record_routing() -> Iterator[List[dict]]:
    """Inside the block, every ``moe_apply`` call appends its routing,
    ``{"expert_idx": (T, k), "keep": (T, k) bool, "gap": (T,)}`` on the
    input's device, to the list it yields, in call order (a stack's layers
    in order). ``gap`` is each token's margin at the top-k boundary, the
    log-probability of its k-th expert less that of its (k+1)-th (inf where
    k = E): how far the router is from a near-tie."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (T, E), gates (T, k) renormalised over the k chosen, expert
    indices (T, k)): the f32 router, the softmax written as the
    reference's (exp(x - max) / Σ); topk returns the k largest in
    descending order, as lax.top_k does."""
    logits = torch.matmul(xf.to(_F32), router.to(_F32))
    un = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = un / un.sum(-1, keepdim=True)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each flat assignment's place in its expert's queue, by a token-major
    one-hot cumsum (T·k, E): earlier tokens win capacity."""
    onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).to(torch.int32)
    return ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)


def experts(params: dict, grouped: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """The expert MLPs on the (E, C, D) dispatch buffer: three grouped
    products, the activation in f32 cast back to the buffer's dtype."""
    gate = _mm("ecd,edf->ecf", grouped, params["wi_gate"])
    up = _mm("ecd,edf->ecf", grouped, params["wi_up"])
    if mlp_kind == "geglu":
        act = F.gelu(gate.to(_F32), approximate="tanh").to(grouped.dtype)
    else:
        act = F.silu(gate.to(_F32)).to(grouped.dtype)
    return _mm("ecf,efd->ecd", act * up, params["wo"])


def moe_apply(params: dict, x: torch.Tensor,  # repro_torch: hot
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), the Switch load-balancing loss, f32
    scalar). Static capacity ``capacity(B·S, cfg)``. Under a mesh context
    the routing and the dispatch run on tokens gathered whole (module
    docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    c = capacity(t, cfg)
    xf = flatten(x, 0, 1)

    probs, gate_vals, expert_idx = route(xf, params["router"], k)  # (T, E), (T, k), (T, k)
    flat_e = gathered(expert_idx.reshape(t * k))  # place 1 (module docstring)

    # load-balancing loss (Switch): E · Σ_e f_e · p_e, f_e counted by a
    # scatter-add of ones (integers, so exact in any order)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=_F32, device=x.device).index_add(
        0, flat_e, torch.ones(t * k, dtype=_F32, device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce)

    pos_in_e = positions(flat_e, e)
    keep = pos_in_e < c
    if _RECORD is not None:
        top = torch.topk(probs, min(k + 1, e), dim=-1).values.log()
        gap = top[:, k - 1] - top[:, k] if k < e else torch.full_like(top[:, 0], math.inf)
        _RECORD.append({"expert_idx": expert_idx, "keep": keep.reshape(t, k), "gap": gap})

    # dispatch into (E·C, D). A kept assignment owns its slot alone; a
    # dropped one adds a zero row to slot 0. So each buffer row receives at
    # most one non-zero row, and index_add is exact whatever order the
    # device's atomics take.
    slot = torch.where(keep, flat_e * c + pos_in_e, 0)
    x_rep = constrain(xf[:, None, :].expand(t, k, d).reshape(t * k, d), ("moe_flat", None))
    x_rep = gathered(x_rep) * keep[:, None].to(x.dtype)  # place 2
    buf = torch.zeros((e * c, d), dtype=x.dtype, device=x.device).index_add(0, slot, x_rep)
    # the expert-parallel layout: E over 'model', capacity over the data axes
    grouped = constrain(buf.reshape(e, c, d), ("experts", "exp_capacity", None))

    h = constrain(experts(params, grouped, cfg.mlp_kind), ("experts", "exp_capacity", None))

    # combine: gather each assignment back, weight it by gate · keep (a
    # dropped one gathers slot 0 and is zeroed), sum over the k experts
    h_flat = gathered(h).reshape(e * c, d)  # place 3
    weight = (gate_vals.reshape(t * k, 1) * keep[:, None]).to(h.dtype)
    y = unflatten(constrain(h_flat[slot] * weight, ("moe_flat", None)), 0, (t, k), ("moe_flat", None, None))
    return unflatten(y.sum(1), 0, (b, s), ("batch", "seq", "act_embed")), aux
