"""Mixture-of-Experts layer: top-k routing with static-capacity dispatch;
the torch counterpart of ``repro.models.moe``.

Dispatch is the reference's deterministic position-in-expert construction:
each flat (token, k) assignment's place in its expert's queue is the number
of earlier assignments, token-major, to the same expert (the reference's
one-hot cumsum; a hand-written kernel on the card, :func:`positions`), and
assignments at or past the static capacity ``C`` are dropped
(capacity-factor semantics). Tokens keep their top-k gates renormalised
over the k chosen experts; a dropped assignment contributes nothing. Every
shape comes from the input's shape and the config (``capacity`` is a Python
int), and no step reads a device value on the host: the layer runs without
a host synchronisation.

The expert MLPs are three batched products over the (E, C, D) dispatch
buffer, the reference's grouped einsums (outside any Pallas kernel there),
so they run as ``torch.bmm``.

Two further kinds, the port's own (Nemotron-H's MoE), are chosen by the
configuration: ``moe_router="sigmoid"`` picks each token's top k by sigmoid
score plus a learned correction bias (``router_bias``, f32), its gates the
raw scores renormalised over the k and times ``moe_routed_scale``;
``mlp_kind="relu2"`` makes each expert ``down(relu(up x)²)``, two batched
products; ``moe_shared_d_ff`` adds a shared expert (``shared``, a dense
relu² MLP of that width; relu² only) on every token, under the span
``moe/shared``. The defaults
(softmax, SwiGLU/GeGLU, no shared expert) run as before, with no added
device work. The mesh paths take the defaults only and raise on the
others.

Under a mesh context (``sharding.act.activation_rules``) the layer keeps
the reference's semantics, global capacity included, and each device works
on its own tokens and its own experts (:func:`_on_mesh`): only the flat
expert ids, small integers, are gathered whole on every device (a cumsum
over a sharded token axis would restart on every shard); the dispatch is a
local scatter into a ``Partial`` buffer that the expert-parallel layout
(E over the model axis, capacity over the data axes) reduce-scatters, and
the combine either gathers each device's experts' outputs over capacity
or, where those are larger than the assignments' rows (experts whole on
every device), writes the rows at the outputs' owners and reduce-scatters
them to the tokens' devices. ``models.moe_shard_map`` is the path with
per-shard capacity and expert all-to-alls.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels.moe_positions import moe_positions
from ..runtime import trace
from ..sharding.act import constrain, current_context, flatten, gathered, replicated, shard_index, use_weight
from ..sharding.rules import axes, placements, resolve
from .layers import _mm, mlp_apply

_F32 = torch.float32

# the routing of every ``moe_apply`` call inside ``record_routing()``
_RECORD: Optional[List[dict]] = None


def moe_init(normal: Callable, cfg: ModelConfig, dtype, device) -> dict:
    """One layer's parameters with the reference's distributions: ``normal``
    draws a seeded f32 normal of a shape times a scale, cast to its ``dt``
    argument (``dtype`` here). The router is (D, E) and f32 whatever
    ``dtype`` is; the experts are ``wi_gate``/``wi_up`` (E, D, F) × 1/√D and
    ``wo`` (E, F, D) × 1/√F, one tensor drawn at a time."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if cfg.mlp_kind == "relu2":  # non-gated: up and down only
        out = {"router": normal((d, e), s_in, dt=_F32),
               "wi_up": normal((e, d, f), s_in, dt=dtype),
               "wo": normal((e, f, d), s_out, dt=dtype)}
    else:
        out = {"router": normal((d, e), s_in, dt=_F32),
               "wi_gate": normal((e, d, f), s_in, dt=dtype),
               "wi_up": normal((e, d, f), s_in, dt=dtype),
               "wo": normal((e, f, d), s_out, dt=dtype)}
    if cfg.moe_router == "sigmoid":
        out["router_bias"] = torch.zeros(e, dtype=_F32, device=device)
    if cfg.moe_shared_d_ff:
        if cfg.mlp_kind != "relu2":
            raise NotImplementedError(f"a shared expert of kind {cfg.mlp_kind!r} ({cfg.name}): relu2 only")
        fs = cfg.moe_shared_d_ff
        out["shared"] = {"wi_up": normal((d, fs), s_in, dt=dtype), "wo": normal((fs, d), 1.0 / math.sqrt(fs), dt=dtype)}
    return out


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
    log-probability of its k-th expert less that of its (k+1)-th (under the
    sigmoid router: its k-th choice score, sigmoid plus bias, less its
    (k+1)-th; inf where k = E): how far the router is from a near-tie."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _record(expert_idx: torch.Tensor, keep: torch.Tensor, probs: torch.Tensor, k: int, log: bool = True) -> None:
    """One call's entry of :func:`record_routing`; ``probs``: what the
    choice ranks (``log``: the softmax probabilities, compared as
    log-probabilities)."""
    top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    top = top.log() if log else top
    gap = top[:, k - 1] - top[:, k] if k < probs.shape[-1] else torch.full_like(top[:, 0], math.inf)
    _RECORD.append({"expert_idx": expert_idx, "keep": keep, "gap": gap})


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


def route_sigmoid(xf: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, k: int, scale: float):
    """(scores (T, E), gates (T, k), expert indices (T, k), choice (T, E)):
    the f32 router's sigmoid scores; the k largest of score + ``bias`` (the
    choice), in descending order; their raw scores renormalised over the k
    and times ``scale`` as the gates."""
    scores = torch.sigmoid(torch.matmul(xf.to(_F32), router.to(_F32)))
    choice = scores + bias.to(_F32)
    expert_idx = torch.topk(choice, k, dim=-1).indices
    gate_vals = scores.gather(-1, expert_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20) * scale
    return scores, gate_vals, expert_idx, choice


def mesh_kinds_unsupported(cfg: ModelConfig) -> None:
    """Raise where the configuration asks the mesh paths for what they do
    not carry: the sigmoid router, relu² experts or a shared expert."""
    off = [name for name, on in (("moe_router='sigmoid'", cfg.moe_router != "softmax"),
                                 ("mlp_kind='relu2'", cfg.mlp_kind == "relu2"),
                                 ("moe_shared_d_ff", cfg.moe_shared_d_ff > 0)) if on]
    if off:
        raise NotImplementedError(f"the MoE mesh paths do not carry {', '.join(off)} ({cfg.name})")


def positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Each flat assignment's place in its expert's queue, token-major:
    earlier tokens win capacity. The integers of the reference's one-hot
    cumsum (T·k, E); on the card a kernel computes them
    (``kernels.moe_positions``)."""
    return moe_positions(flat_e, e)


def experts(params: dict, grouped: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """The expert MLPs on the (E, C, D) dispatch buffer: three grouped
    products (relu²: two), the activation in f32 cast back to the buffer's
    dtype."""
    if mlp_kind == "relu2":
        up = _mm("ecd,edf->ecf", grouped, use_weight(params["wi_up"]))
        act = F.relu(up.to(_F32)).square().to(grouped.dtype)
        return _mm("ecf,efd->ecd", act, use_weight(params["wo"]))
    gate = _mm("ecd,edf->ecf", grouped, use_weight(params["wi_gate"]))
    up = _mm("ecd,edf->ecf", grouped, use_weight(params["wi_up"]))
    if mlp_kind == "geglu":
        act = F.gelu(gate.to(_F32), approximate="tanh").to(grouped.dtype)
    else:
        act = F.silu(gate.to(_F32)).to(grouped.dtype)
    return _mm("ecf,efd->ecd", act * up, use_weight(params["wo"]))


def moe_apply(params: dict, x: torch.Tensor,  # repro_torch: hot
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), the Switch load-balancing loss, f32
    scalar). Static capacity ``capacity(B·S, cfg)``. Under a mesh context
    each device dispatches its own tokens to its own experts (module
    docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    c = capacity(t, cfg)
    ctx = current_context()
    if ctx is not None:
        mesh_kinds_unsupported(cfg)
        x = replicated(x, ctx[1])
    xf = flatten(x, 0, 1)

    # the router at its use: E over the model axis where it divides, so the
    # model-axis devices share the routing product
    router = use_weight(params["router"], ("embed", "experts"))
    if cfg.moe_router == "sigmoid":
        probs, gate_vals, expert_idx, choice = route_sigmoid(xf, router, params["router_bias"], k,
                                                             cfg.moe_routed_scale)
    else:
        probs, gate_vals, expert_idx = route(xf, router, k)  # (T, E), (T, k), (T, k)
    flat_e = gathered(expert_idx.reshape(t * k))  # every device's copy (module docstring)

    # load-balancing loss (Switch): E · Σ_e f_e · p_e, f_e counted by a
    # scatter-add of ones (integers, so exact in any order)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=_F32, device=x.device).index_add(
        0, flat_e, torch.ones(t * k, dtype=_F32, device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce)
    if ctx is not None:
        return _on_mesh(params, x, probs, gate_vals, expert_idx, flat_e, cfg, c), aux

    with trace.span("moe/dispatch"):
        pos_in_e = positions(flat_e, e)
        keep = pos_in_e < c
        if _RECORD is not None:
            if cfg.moe_router == "sigmoid":
                _record(expert_idx, keep.reshape(t, k), choice, k, log=False)
            else:
                _record(expert_idx, keep.reshape(t, k), probs, k)

        # dispatch into (E·C, D). A kept assignment owns its slot alone; a
        # dropped one adds a zero row to slot 0. So each buffer row receives
        # at most one non-zero row, and index_add is exact whatever order
        # the device's atomics take.
        slot = torch.where(keep, flat_e * c + pos_in_e, 0)
        x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d) * keep[:, None].to(x.dtype)
        buf = torch.zeros((e * c, d), dtype=x.dtype, device=x.device).index_add(0, slot, x_rep)
    if trace.counting():  # the expert rows computed, and those an assignment fills
        trace.count("moe/rows", e * c)
        trace.count("moe/kept", keep.sum())
    with trace.span("moe/experts"):
        h = experts(params, buf.reshape(e, c, d), cfg.mlp_kind)

    # combine: gather each assignment back, weight it by gate · keep (a
    # dropped one gathers slot 0 and is zeroed), sum over the k experts
    with trace.span("moe/combine"):
        weight = (gate_vals.reshape(t * k, 1) * keep[:, None]).to(h.dtype)
        y = (h.reshape(e * c, d)[slot] * weight).reshape(t, k, d).sum(1)
    y = y.reshape(b, s, d)
    if cfg.moe_shared_d_ff:
        with trace.span("moe/shared"):
            y = y + mlp_apply(params["shared"], x, cfg.mlp_kind)
    return y, aux


def _on_mesh(params: dict, x: DTensor, probs: DTensor, gate_vals: DTensor, expert_idx: DTensor,
             flat_e: DTensor, cfg: ModelConfig, c: int) -> DTensor:
    """The dispatch, the experts and the combine of :func:`moe_apply` on a
    mesh, with its global capacity, each device working on its own tokens
    (B over the data axes) and on the experts it holds in the grouped
    layout (E over the model axis where E divides it):

      * positions: the local positions plus the counts of the
        assignments before this device's tokens (from the flat expert ids,
        small integers gathered whole), so each kept assignment owns the
        slot it owns in the unsharded layer;
      * dispatch: each device scatters the assignments of its tokens to its
        own experts into an (E_loc, C, D) buffer, a ``Partial`` sum over the
        data axes (every slot written by one device, the others adding
        zeros, so exact in any order), which the grouped layout
        reduce-scatters over capacity;
      * combine: the expert outputs gathered over capacity, each device
        picks its tokens' rows from its experts; the sum over the model
        axis is left ``Partial`` for the residual's reduce-scatter. Where a
        device's share of the outputs outsizes the assignments' rows, the
        rows are picked at the outputs' owners instead
        (:func:`_combine_at_owners`).

    Routing, drops and values are the unsharded layer's; the gradients
    reduce-scatter and gather back the same way."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    mesh = x.device_mesh
    rules, _ = current_context()
    tok = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    x = x.redistribute(mesh, [Shard(0) if i in tok else Replicate() for i in range(mesh.ndim)])
    grouped_pl = placements(resolve((e, c, d), ("experts", "exp_capacity", None), rules, axes(mesh)), mesh)
    ep = [i for i, p in enumerate(grouped_pl) if p == Shard(0) and i not in tok]
    e_loc = e // math.prod(  # repro_torch: noqa[f64-promote]: mesh sizes, Python ints
        mesh.size(i) for i in ep)
    e0 = shard_index(mesh, ep) * e_loc  # this device's first expert

    def pl(on_tok, on_ep):
        return [on_tok if i in tok else on_ep if i in ep else Replicate() for i in range(mesh.ndim)]

    x_l = x.to_local(grad_placements=pl(Shard(0), Partial()))
    gates_l = gate_vals.redistribute(mesh, pl(Shard(0), Replicate())).to_local(
        grad_placements=pl(Shard(0), Partial()))
    idx_l = expert_idx.redistribute(mesh, pl(Shard(0), Replicate())).to_local()
    flat_l = flat_e.to_local()  # whole
    t_l = x_l.shape[0] * s

    f = idx_l.reshape(t_l * k)
    start = shard_index(mesh, tok) * t_l * k  # the flat assignments before this device's
    before = flat_l[:start]
    prefix = torch.zeros(e, dtype=torch.long, device=f.device).index_add(0, before, torch.ones_like(before))
    pos_in_e = positions(f, e) + prefix[f]
    keep = pos_in_e < c
    mine = keep & (f >= e0) & (f < e0 + e_loc)
    if _RECORD is not None:
        _record(expert_idx, DTensor.from_local(keep.reshape(-1, k), mesh, pl(Shard(0), Replicate()),
                                               run_check=False), probs, k)
    slot = torch.where(mine, (f - e0) * c + pos_in_e, 0)
    x_rep = x_l.reshape(t_l, d)[:, None, :].expand(t_l, k, d).reshape(t_l * k, d) * mine[:, None].to(x.dtype)
    buf = torch.zeros((e_loc * c, d), dtype=x.dtype, device=x_l.device).index_add(0, slot, x_rep)
    buf = DTensor.from_local(buf.reshape(e_loc, c, d), mesh, pl(Partial(), Shard(0)), run_check=False,
                             shape=(e, c, d), stride=(c * d, d, 1))
    grouped = constrain(buf, ("experts", "exp_capacity", None))

    h = experts(params, grouped, cfg.mlp_kind)
    cap = [i for i, p in enumerate(grouped_pl) if p == Shard(1)]
    if cap == tok and e_loc * c > b * s * k:
        return _combine_at_owners(h, cap, gate_vals, flat_l, cfg, c, (b, s, d))
    h = constrain(h, ("experts", "exp_capacity", None))
    h_l = h.redistribute(mesh, pl(Replicate(), Shard(0))).to_local(grad_placements=pl(Partial(), Shard(0)))
    weight = (gates_l.reshape(t_l * k, 1) * mine[:, None]).to(h_l.dtype)
    y = (h_l.reshape(e_loc * c, d)[slot] * weight).reshape(t_l, k, d).sum(1)
    return DTensor.from_local(y.reshape(-1, s, d), mesh, pl(Shard(0), Partial()), run_check=False,
                              shape=(b, s, d), stride=(s * d, d, 1))


def _combine_at_owners(h: DTensor, cap, gate_vals: DTensor, flat_e: torch.Tensor, cfg: ModelConfig,
                       c: int, shape) -> DTensor:
    """The combine where a device's share of the expert outputs is larger
    than the assignments' rows (experts whole on every device: grok-1's 8
    over 16): each device, holding the capacity rows of its share of the
    ``cap`` (data) axes, writes every assignment its rows serve into a
    (T·k, D) block, zero elsewhere; a reduce-scatter over those axes sums
    the blocks (one non-zero row each, so exact) onto the devices that hold
    the tokens. Its gradient is one all-gather, in the backward, where
    gathering the outputs would be one in the forward and one in its
    recompute. A partial sum over the model axis stays partial, for the
    residual's reduce-scatter. ``flat_e``: every flat assignment's expert."""
    b, s, d = shape
    e, k = cfg.n_experts, cfg.top_k
    mesh = h.device_mesh
    h_pl = [Shard(1) if i in cap else (p if p.is_partial() else Replicate()) for i, p in enumerate(h.placements)]
    h_l = h.redistribute(mesh, h_pl).to_local(grad_placements=[Replicate() if p.is_partial() else p for p in h_pl])
    c_loc = h_l.shape[1]
    c0 = shard_index(mesh, cap) * c_loc
    pos_in_e = positions(flat_e, e)
    here = (pos_in_e < c) & (pos_in_e >= c0) & (pos_in_e < c0 + c_loc)
    slot = torch.where(here, flat_e * c_loc + pos_in_e - c0, 0)
    gates = gate_vals.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in cap or p.is_partial() else Replicate() for i, p in enumerate(h_pl)])
    weight = (gates.reshape(b * s * k, 1) * here[:, None]).to(h_l.dtype)
    y = DTensor.from_local(h_l.reshape(e * c_loc, d)[slot] * weight, mesh,
                           [Partial() if i in cap else p for i, p in enumerate(h_pl)], run_check=False,
                           shape=(b * s * k, d), stride=(d, 1))
    y = y.redistribute(mesh, [Shard(0) if i in cap else p for i, p in enumerate(h_pl)])
    return y.reshape(b * s, k, d).sum(1).reshape(b, s, d)
