"""Expert-parallel MoE dispatch: per-shard local capacity and an expert
all-to-all; the torch counterpart of ``repro.models.moe_shard_map``.

Why this exists: the dense dispatch (``models.moe``) scatters tokens into
the grouped buffer with data-dependent indices over a *global* flat axis,
which no placement shards, so under a mesh it runs on tokens gathered
whole. Here every device dispatches only its own tokens (local cumsum,
local scatter into an (E, C_loc) slice), then one all-to-all over the
model axis exchanges expert ownership for token ownership, and a second
one brings the expert outputs back: the textbook EP exchange, and the only
collectives in the path besides the aux loss's mean.

Semantics difference vs the dense path: capacity is **per data×SP shard**
(C_loc = max(k, ⌈T_loc·k·cf/E⌉)) rather than global. With axis sizes of 1
the two paths agree (tested).

Layout of the exchanges. JAX's ``all_to_all(split_axis=0, concat_axis=1,
tiled=True)`` turns the (E, C_loc, D) buffer into (E_loc, model_n·C_loc,
D), the source shard major within the capacity axis; torch's
``all_to_all_single`` splits and concatenates dim 0 only, so the received
(model_n · E_loc, C_loc, D) rows are permuted into that order, and the
return exchange permutes (E_loc, model_n, C_loc, D) to source-major before
sending. Equal splits: no host sync. Both exchanges are
``all_to_all_single_autograd`` over ``mesh.get_group("model")``, whose
backward is the reverse exchange (2 forward, 2 backward).

Gradients follow ``shard_map``'s own rule (the reference disables the
replication check): an output replicated over a mesh axis takes its
cotangent divided by that axis's size on each device, and an input
replicated over an axis gets the per-device cotangents summed over it (its
local gradient enters DTensor as ``Partial`` there). So a token block that
every model shard computes alike (no sequence sharding) gets its true
gradient, not model_n times it.

Applicability: EP only (n_experts divisible by the model axis); grok-1
(8 experts on a 16-way model axis) keeps the dense path.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import all_to_all_single_autograd
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..configs.base import ModelConfig
from ..sharding.act import replicated
from ..sharding.rules import axes, placements
from .moe import experts, mesh_kinds_unsupported, positions, route

_F32 = torch.float32


def _local_dispatch(xf: torch.Tensor, gate_vals: torch.Tensor, expert_idx: torch.Tensor,
                    c_loc: int, e: int):
    """Local capacity dispatch over this shard's tokens. xf (T_loc, D) →
    (grouped (E, C_loc, D), slot, keep, gates), as ``moe_apply`` dispatches
    (kept assignments own their slot; a dropped one adds a zero row to
    slot 0, so ``index_add`` is exact in any order)."""
    t, d = xf.shape
    k = expert_idx.shape[1]
    flat_e = expert_idx.reshape(t * k)
    pos_in_e = positions(flat_e, e)
    keep = pos_in_e < c_loc
    slot = torch.where(keep, flat_e * c_loc + pos_in_e, 0)
    x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d) * keep[:, None].to(xf.dtype)
    grouped = torch.zeros((e * c_loc, d), dtype=xf.dtype, device=xf.device).index_add(0, slot, x_rep)
    return grouped.reshape(e, c_loc, d), slot, keep, gate_vals


class _GradScale(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` in the backward."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _PSum(torch.autograd.Function):
    """Sum over the ranks of each group in turn; the backward sums the
    cotangents the same way (JAX's ``psum`` and its transpose)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all of dim 0 over ``group`` (autograd-aware)."""
    return all_to_all_single_autograd(x.contiguous(), None, None, group)


def _grad_placements(pl):
    """A local input's gradient: ``Partial`` over the mesh dims the input is
    replicated on (each device holds its own share of it)."""
    return tuple(Partial() if p == Replicate() else p for p in pl)


def moe_apply_shard_map(
    params: dict,
    x: torch.Tensor,  # (B, S, D): batch over the data axes, seq over model (SP) where the rules say
    cfg: ModelConfig,
    mesh,
    rules,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D) a DTensor placed as the block's tokens, aux a
    replicated f32 scalar DTensor)."""
    mesh_kinds_unsupported(cfg)
    e, k = cfg.n_experts, cfg.top_k
    sizes = axes(mesh).shape
    model_n = sizes["model"]
    if e % model_n:
        raise ValueError(f"shard_map MoE needs the {e} experts to divide the model axis of {model_n}")
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    batch_axes = tuple(rules.get("batch") or data_axes)
    seq_axes = rules.get("seq_res")
    sp = model_n if seq_axes else 1

    b, s, d = x.shape
    n_data = math.prod(sizes[a] for a in batch_axes)
    if b % n_data or s % sp:
        batch_axes, n_data = (), 1  # fall back to replicated-batch blocks
    if s % sp:
        raise ValueError(f"sequence {s} does not split over the model axis of {sp}")
    t_loc = (b // n_data) * (s // sp)
    c_loc = max(k, int(math.ceil(t_loc * k * cfg.capacity_factor / e)))

    x_pl = placements((batch_axes or None, "model" if seq_axes else None, None), mesh)
    w_pl = placements(("model", None, None), mesh)  # (E, D, F) and (E, F, D): EP
    r_pl = placements((None, None), mesh)
    xl = replicated(x, mesh).redistribute(mesh, x_pl).to_local(grad_placements=_grad_placements(x_pl))
    router = replicated(params["router"], mesh).redistribute(mesh, r_pl).to_local(
        grad_placements=_grad_placements(r_pl))
    w = {n: replicated(params[n], mesh).redistribute(mesh, w_pl).to_local(
        grad_placements=_grad_placements(w_pl)) for n in ("wi_gate", "wi_up", "wo")}
    group = mesh.get_group("model")
    names = tuple(mesh.mesh_dim_names)
    mean_axes = batch_axes + (("model",) if seq_axes else ())

    # ---- the block on this device's tokens --------------------------------
    bl, sl, _ = xl.shape
    xf = xl.reshape(bl * sl, d)
    probs, gate_vals, expert_idx = route(xf, router, k)
    grouped, slot, keep, gates = _local_dispatch(xf, gate_vals, expert_idx, c_loc, e)

    # aux loss (Switch): local fractions, averaged over every token shard
    me = probs.mean(0)
    ce_cnt = torch.zeros(e, dtype=_F32, device=xf.device).index_add(
        0, slot // c_loc, keep.to(_F32)) / (bl * sl * k)
    aux = e * torch.sum(me * ce_cnt)
    if mean_axes:
        aux = _PSum.apply(aux, [mesh.get_group(a) for a in mean_axes]) / math.prod(
            sizes[a] for a in mean_axes)

    # EP exchange: expert ownership ↔ token ownership over 'model'
    e_loc = e // model_n
    recv = _exchange(grouped, group)  # (model_n · E_loc, C_loc, D), source-major
    grouped = recv.reshape(model_n, e_loc, c_loc, d).transpose(0, 1).reshape(e_loc, model_n * c_loc, d)
    h = experts(w, grouped, cfg.mlp_kind)  # (E_loc, model_n · C_loc, D)
    send = h.reshape(e_loc, model_n, c_loc, d).transpose(0, 1)  # (model_n, E_loc, C_loc, D)
    h = _exchange(send.reshape(model_n * e_loc, c_loc, d), group)  # (E, C_loc, D)

    weight = (gates.reshape(-1, 1) * keep[:, None]).to(h.dtype)
    y = (h.reshape(e * c_loc, d)[slot] * weight).reshape(bl * sl, k, d).sum(1).reshape(bl, sl, d)

    # ---- back to DTensors, with shard_map's cotangent rule ----------------
    y_unmentioned = math.prod(sizes[n] for n, p in zip(names, x_pl) if p == Replicate())
    y = DTensor.from_local(_GradScale.apply(y, 1.0 / y_unmentioned), mesh, x_pl, run_check=False)
    aux = DTensor.from_local(_GradScale.apply(aux, 1.0 / math.prod(sizes.values())), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    return y, aux
