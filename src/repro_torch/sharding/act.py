"""Logical activation-sharding constraints: the torch counterpart of
``repro.sharding.act``.

``constrain(x, logical_axes)`` pins an intermediate tensor's placement with
the active (rules, mesh) context: the logical names resolve to a spec
(``rules.resolve``), the spec to one DTensor placement per mesh dim
(``rules.placements``), and a DTensor is redistributed to them (a local
slice, an all-gather, a reduce-scatter or an all-to-all, as the two
placements need). With no context installed it returns its input: every
single-device path computes what it computed before, bit for bit.

Under a context a plain tensor is the global value, the same on every
rank (a batch that every rank loaded, a position ``arange``): ``constrain``
wraps it as replicated and redistributes it like any DTensor, so it never
stays unsharded where the reference shards it. :func:`activation_rules`
also turns on DTensor's implicit replication for its extent, so plain
tensors that meet DTensors inside an op (masks, positions, the aux
accumulator) count as replicated values too.

Why this exists: propagation alone picks bad placements at contraction
conflicts — e.g. the tied-embedding LM head (contracting dim FSDP-sharded on
the weight, batch dim data-sharded on the activation) would replicate the
*batch* of the f32 logits. Constraining activations at block boundaries
keeps batch on the data axes everywhere.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import implicit_replication, local_map

from .rules import axes, placements, resolve

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_rules", default=None)


@contextlib.contextmanager
def activation_rules(rules: dict, mesh) -> Iterator[None]:
    """Install (rules, mesh) for the extent of the block (a step, a
    forward). ``mesh`` is a ``DeviceMesh`` with named dims."""
    outer = _CTX.get()
    token = _CTX.set((rules, mesh))
    try:
        if outer is None:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(token)


def in_context(fn: Callable) -> Callable:
    """``fn`` bound to the context installed now. Activation checkpointing
    re-runs its function in the backward, which for CUDA tensors autograd
    runs on its own device thread, where this module's context variable is
    unset: the recompute must see the forward's (rules, mesh), or its
    constraints vanish and its placements differ from the forward's."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return run


def replicated(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor holding the global value on every rank, as a
    replicated DTensor on ``mesh`` (a DTensor is returned as it is)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value, the same plain tensor on every rank (a
    ``Partial`` one reduced first); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def gathered(x: torch.Tensor) -> torch.Tensor:
    """Under a context, a DTensor redistributed to whole on every device
    (the explicit counterpart of GSPMD's all-gather before an op no
    placement shards); otherwise ``x`` as it is."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def constrain(x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    rules, mesh = ctx
    spec = resolve(tuple(x.shape), logical, rules, axes(mesh))
    return replicated(x, mesh).redistribute(mesh, placements(spec, mesh))


def current_context():
    """(rules, mesh) if a distribution context is installed, else None —
    lets layers pick shard_map implementations only when actually sharded."""
    return _CTX.get()


def on_shards(fn: Callable, args: Sequence, in_placements: Sequence, out_placements: Sequence,
              work: Tuple) -> object:
    """``fn`` on each device's shards (``local_map``): every DTensor of
    ``args`` is redistributed to its entry of ``in_placements`` (None for a
    non-tensor argument), ``fn`` gets the local shards, and its outputs
    come back as DTensors placed by ``out_placements`` (one entry per
    output). ``work`` is how the
    devices split the work (the main output's placements): an input whole
    on a mesh dim that splits the work gets its gradient as ``Partial``
    there, each device holding its share. The kernel wrappers run their
    kernels through this, on placements that keep every dimension the
    kernel reduces or scans whole."""
    grads = tuple(None if pl is None else tuple(
        Partial() if p == Replicate() and w != Replicate() else p for p, w in zip(pl, work))
        for pl in in_placements)
    return local_map(fn, out_placements=tuple(out_placements), in_placements=tuple(in_placements),
                     in_grad_placements=grads, redistribute_inputs=True)(*args)
