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

XLA propagates a constraint back into the op that produced the tensor;
DTensor does not, so a constraint after a product only slices a result
that was already gathered. The weights are therefore placed before their
products (:func:`use_weight`): whole over the data axes at their use, as
the reference's partitioner gathers an FSDP weight inside the remat'd
layer, with the gradient reduce-scattered back to its shard at the same
use.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

from .rules import axes, placements, resolve

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_rules", default=None)
_AS_PLACED: contextvars.ContextVar = contextvars.ContextVar("weights_as_placed", default=False)


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


DATA_AXES = ("pod", "data")  # the mesh axes that weights shard FSDP-style


def use_weight(w: torch.Tensor, logical: Optional[Tuple[Optional[str], ...]] = None) -> torch.Tensor:
    """A weight placed for its product, the reference partitioner's FSDP
    layout: under a context, ``w`` whole over the data axes (the all-gather
    of one weight) and, over the model axis, as its own placement has it or,
    where ``logical`` names the axes of its use, as those resolve (the LM
    head: vocab over ``act_vocab``). The model axis moves first, so a dim it
    comes to shard is never gathered whole. Its gradient goes back through
    the same two redistributions reversed: the product's ``Partial`` sum
    over the data axes becomes the FSDP shard there (a reduce-scatter), at
    this use, so no unreduced gradient outlives the layer. Call it inside
    the remat unit: the recompute gathers again and nothing gathered is
    saved across units. With no context, on a plain tensor, or inside
    :func:`weights_as_placed`, ``w`` as it is."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(w, DTensor) or _AS_PLACED.get():
        return w
    rules, mesh = ctx
    names = tuple(w.device_mesh.mesh_dim_names)
    if logical is None:
        model = tuple(w.placements)
    else:
        no_data = {k: _drop_data(v) for k, v in rules.items()}
        model = placements(resolve(tuple(w.shape), logical, no_data, axes(mesh)), mesh)
    on_model = tuple(p if n in DATA_AXES else m for n, p, m in zip(names, w.placements, model))
    whole_data = tuple(Replicate() if n in DATA_AXES else p for n, p in zip(names, on_model))
    if on_model != tuple(w.placements):
        w = w.redistribute(w.device_mesh, on_model)
    return w.redistribute(w.device_mesh, whole_data) if whole_data != on_model else w


@contextlib.contextmanager
def weights_as_placed() -> Iterator[None]:
    """:func:`use_weight` leaves every weight where its rule places it for
    the extent of the block: the serving steps (prefill and decode). The
    FSDP gather pairs with its gradient's reduce-scatter in a train step;
    with no gradient, a product on the FSDP shards that moves activations
    (a token's, at decode) or gathers what DTensor picks moves no more
    than the weights would (the dry run's prefill and decode cells,
    ``tests/test_torch_layout.py``, ``tests/test_torch_layout_prefill.py``)."""
    token = _AS_PLACED.set(True)
    try:
        yield
    finally:
        _AS_PLACED.reset(token)


def _drop_data(rule):
    """A rule's mesh axes without the data axes (None where none is left)."""
    if rule is None:
        return None
    kept = tuple(a for a in ((rule,) if isinstance(rule, str) else rule) if a not in DATA_AXES)
    return kept or None


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


def local_product(x: DTensor, w: DTensor, fn: Callable = torch.matmul) -> DTensor:
    """``fn(x, w)``, a product ``x @ w`` (x (..., D), w (D, E)), on each
    device's shards, where x and w are placed for a product with no
    collective: D whole on both, x's other dims and w's E sharded over
    different mesh dims. The result is placed as x, with E sharded where w
    shards it. DTensor's own matmul flattens x's leading dims, which it
    cannot do on the card's torch where two mesh dims shard them (a
    sequence-split head or K/V projection)."""
    out = tuple(Shard(x.ndim - 1) if pw == Shard(1) else px for px, pw in zip(x.placements, w.placements))
    return on_shards(fn, (x, w), (x.placements, w.placements), [out], work=out)


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


# ---------------------------------------------------------------------------
# head layouts: DTensor cannot view a dim it shards unevenly, where XLA's
# partitioner reshards such a reshape by itself
# ---------------------------------------------------------------------------
def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...],
              logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    """``x`` with dim ``dim`` viewed as ``sizes``. Under a context ``x``
    first takes the layout that ``logical`` resolves for the result, of the
    split dims only the leading one sharded: DTensor cannot view a dim that
    it shards over an axis the leading size does not divide (a projection's
    1,024 columns that propagation sharded over 16, viewed as 8 KV heads;
    256 MoE rows over 256 devices viewed as 128 tokens × 2). The gradient
    is pinned to the result's layout (:func:`_pinned`)."""
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    ctx = _CTX.get()
    if ctx is not None:
        rules, mesh = ctx
        n = len(sizes)

        def on_x(p):  # the result's placement as one of x's
            if not isinstance(p, Shard) or p.dim <= dim:
                return p
            return Replicate() if p.dim < dim + n else Shard(p.dim - n + 1)

        spec = resolve(shape, logical, rules, axes(mesh))
        x = replicated(x, mesh).redistribute(mesh, tuple(on_x(p) for p in placements(spec, mesh)))
    return _pinned(x.reshape(shape))


def shard_index(mesh, dims) -> int:
    """This device's shard along a tensor dim sharded over the mesh dims
    ``dims`` together, the major one first (mesh order)."""
    index = 0
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    return index


def write_position(dst: torch.Tensor, index: int, src: torch.Tensor) -> None:
    """``dst[:, index] = src`` in place (dst (B, S, ...), src (B, ...)). A
    DTensor ``dst`` whose S is sharded is written on the device holding
    position ``index`` only, at its local row: DTensor's own select along a
    sharded dim writes every device's local row ``index``."""
    seq_dims = [i for i, p in enumerate(dst.placements)
                if isinstance(p, Shard) and p.dim == 1] if isinstance(dst, DTensor) else []
    if not seq_dims:
        dst[:, index] = src
        return
    mesh = dst.device_mesh
    pl = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1 else Shard(p.dim - (p.dim > 1))
               for p in dst.placements)
    row = replicated(src, mesh).redistribute(mesh, pl).to_local()
    local = dst.to_local()
    start = shard_index(mesh, seq_dims) * local.shape[1]
    if start <= index < start + local.shape[1]:
        local[:, index - start] = row


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) → (B, S, H·Dh); a DTensor's head-dim shard made whole
    first (a flattened dim may be sharded only on its major part), then
    :func:`flatten`."""
    if isinstance(x, DTensor) and Shard(3) in x.placements:
        x = x.redistribute(x.device_mesh, tuple(Replicate() if p == Shard(3) else p for p in x.placements))
    return flatten(x, 2, 3)


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``, the gradient pinned to the result's layout
    (:func:`_pinned`): the backward views the gradient back, and a flat dim
    that arrived sharded over more devices than its leading size has (a
    (B·S) MoE token axis over every device, B over the data axes only)
    cannot be viewed."""
    return _pinned(x.flatten(start, end))


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient brought to x's layout in the backward:
    the view that made x is undone there on whatever layout the gradient
    arrives in, which DTensor may be unable to view (a flat dim sharded
    over an axis the head count does not divide)."""
    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: a local shard's gradient
    goes back to DTensor, which takes its strides as the shard's layout and
    may later view it as the global tensor's strides allow (an einsum's
    backward hands back permuted strides)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def attention_on_shards(fn: Callable, q: DTensor, k, v) -> DTensor:
    """Attention ``fn(q, k, v)`` (model layout (B, S, H, Dh); KV heads KH)
    on each device's shards: the batch rows and the query heads as q has
    them sharded, the sequence and the head dim whole (attention is local
    to each (batch row, head)); the KV heads sharded with the query heads
    where k has them so, otherwise whole on every device, each device
    slicing out the KV heads its own query heads read (GQA: query head h
    reads KV head h // (H / KH))."""
    mesh = q.device_mesh
    whole = (Replicate(),) * mesh.ndim
    q_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements)
    k_in = k.placements if isinstance(k, DTensor) else whole
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    kv_heads_sharded = all(k_in[i] == Shard(2) for i in heads)
    kv_pl = tuple(Shard(0) if p == Shard(0) else (Shard(2) if p == Shard(2) and kv_heads_sharded
                                                  else Replicate()) for p in q_pl)
    h, kh = q.shape[2], k.shape[2]
    h_loc = h // math.prod(mesh.size(i) for i in heads)
    kv_slice = None
    if heads and not kv_heads_sharded:  # this device's query heads, and the KV heads they read
        g = h // kh
        if h_loc % g and g % h_loc:
            raise ValueError(f"{h_loc} query heads a device do not group over {kh} KV heads")
        start = shard_index(mesh, heads) * h_loc // g
        kv_slice = slice(start, start + max(h_loc // g, 1))

    def local(ql, kl, vl):
        if torch.is_grad_enabled():
            ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice], vl[:, :, kv_slice]
        return fn(ql, kl, vl)

    return on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), [q_pl], work=q_pl)
