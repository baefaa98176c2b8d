"""Logical-axis → mesh-axis rules with per-array conflict/divisibility
resolution: the pure half of the reference's ``repro.sharding.rules``.

``resolve(shape, logical, rules, mesh)`` walks the dims in order; each logical
name proposes mesh axes, which are accepted only if (a) not already used by an
earlier dim of the same array and (b) the dim is divisible by the accumulated
axis size. This one mechanism yields the per-arch fallbacks: kv-head
replication when K·Dh doesn't divide, EP→expert-TP for grok-1 (8 experts <
16-way model axis), replicated vocab for mamba2's 50280, replicated batch for
long_500k's batch=1 (which then turns on sequence-sharded KV).

The rules dict is *the* FARSI design point for the distributed layer — the
autotuner's migrate move edits it, swap edits remat/microbatch knobs.

A mesh here is any object with ``shape`` (a mapping from axis name to size)
and ``axis_names``, or a ``DeviceMesh`` with named dims (:func:`axes` gives
its view); ``resolve`` returns the spec (one entry per dim: None, an axis
name, or a tuple of names) that the reference wraps in
``PartitionSpec(*parts)``.

The mesh half turns a spec into DTensor placements, one per mesh dim
(:func:`placements`), and describes placed leaves without allocating them
(:class:`Sharding`, :class:`ShardedStruct`, :func:`sharded_struct`,
:func:`tree_sharded_structs`, :func:`tree_shardings`). A tensor dim sharded
over a tuple of mesh axes shards in mesh order, the major axis first, as
JAX's ``P(("pod", "data"))`` does; a tuple out of mesh order raises (DTensor
would need a strided shard for it, and neither ``default_rules`` nor the
autotuner's moves make one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.placement_types import Placement

from ..configs.base import ModelConfig, ShapeConfig

Axes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """One point in the distribution design space (FARSI 'design')."""

    rules: Dict[str, Axes]
    remat: str = "full"  # train-time activation checkpointing
    attn_impl: str = "blockwise"
    q_block: int = 512
    kv_block: int = 1024
    ssd_chunk: int = 64
    microbatches: int = 4  # gradient-accumulation splits of the global batch
    kv_quant: str = "none"  # "int8" halves the decode cache footprint/traffic
    a2a_bytes: int = 2  # MoE dispatch payload width (1 = int8-quantized a2a)
    grad_compress: str = "none"  # "int8" = error-feedback compressed grad sync
    capacity_factor: float = 0.0  # >0 overrides the arch's MoE capacity factor
    moe_impl: str = "dense"  # "shard_map" = EP local-dispatch (models/moe_shard_map.py)
    ici_links: int = 1  # collective schedule: 2 = bidirectional-ring on the torus
    donate_state: bool = True

    def replace(self, **kw) -> "DistConfig":
        return dataclasses.replace(self, **kw)


def default_rules(cfg: ModelConfig, shape: ShapeConfig, mesh: Any) -> Dict[str, Axes]:
    mesh = axes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    # KV projections: shard over 'model' only when the kv-head count divides
    # it; otherwise replicate them (Megatron GQA-style — each model shard
    # computes the full small K/V locally rather than fighting a Dh-split
    # layout through attention).
    kv_sharded = (
        cfg.n_kv_heads > 0 and cfg.n_kv_heads % mesh.shape["model"] == 0
    )
    rules: Dict[str, Axes] = {
        # activations
        "batch": data_axes,
        "seq": None,
        # residual stream between blocks: sequence-sharded over the model
        # axis (Megatron sequence parallelism) — divides the L×tokens×d_model
        # remat-residual stack by the TP degree. Auto-dropped when S % 16 ≠ 0
        # or S == 1 (decode).
        "seq_res": ("model",),
        "act_embed": None,
        "act_heads": ("model",),
        "act_kv_heads": ("model",) if kv_sharded else None,
        "act_kv_dim": None,
        "act_vocab": ("model",),
        "exp_capacity": data_axes,
        # flat (T·k, D) MoE dispatch tensors: shard the token axis over
        # everything available
        "moe_flat": data_axes + ("model",),
        # weights: TP over 'model', FSDP over 'data'
        "embed": ("data",),
        "qkv": ("model",),
        "kv_qkv": ("model",) if kv_sharded else None,
        "mlp": ("model",),
        "vocab": ("model",),
        "vocab_table": None,
        "experts": ("model",),
        "expert_mlp": ("model",),
        "ssm_inner": ("model",),
        "ssm_conv": ("model",),
        "ssm_heads": ("model",),
        "layers": None,  # scan axis
        # decode cache
        "cache_seq": None,
        "kv_heads": ("model",),
        "head_dim": ("model",),
    }
    # batch too small to fill the data axes (long_500k): shard the KV cache
    # and activations over sequence instead (flash-decoding style).
    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]
    if shape.kind == "decode" and shape.global_batch < n_data:
        rules["cache_seq"] = data_axes
    if shape.kind != "decode" and shape.global_batch < n_data:
        rules["seq"] = data_axes
    return rules


def resolve(shape: Tuple[int, ...], logical, rules: Dict[str, Axes], mesh: Any) -> Tuple[Axes, ...]:
    used = set()
    parts = []
    for dim, lname in zip(shape, logical):
        axes = rules.get(lname) if lname else None
        if axes is None:
            parts.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        chosen = []
        size = 1
        for ax in axes:
            if ax in used or ax not in mesh.shape:
                continue
            if dim % (size * mesh.shape[ax]) == 0:
                chosen.append(ax)
                size *= mesh.shape[ax]
        used.update(chosen)
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return tuple(parts)


# ---------------------------------------------------------------------------
# the mesh half: placements on a DeviceMesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AxisSizes:
    """The view of a mesh that ``resolve`` and ``default_rules`` read."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


def axes(mesh: Any) -> Any:
    """``mesh`` as ``resolve`` reads it: a ``DeviceMesh``'s named dims as
    an :class:`AxisSizes`; any object whose ``shape`` is already a mapping
    as it is."""
    if isinstance(mesh.shape, dict):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return AxisSizes(dict(zip(names, mesh.shape)), names)


def placements(spec: Tuple[Axes, ...], mesh: Any) -> Tuple[Placement, ...]:
    """One DTensor placement per mesh dim for a resolved ``spec``: the mesh
    dims a tensor dim names shard that dim (several of them in mesh order,
    the major one first), every other mesh dim replicates. Raises on an
    axis the mesh lacks, an axis named twice, or a tuple out of mesh order."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        missing = [a for a in group if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: axes {missing} are not in the mesh {names}")
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} shards over {group}, out of the mesh order "
                             f"{names}; list the axes major first")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives: the mesh, the resolved spec and its placements
    (the counterpart of ``NamedSharding(mesh, spec)``)."""

    mesh: Any
    spec: Tuple[Axes, ...]
    placements: Tuple[Placement, ...]

    @classmethod
    def of(cls, mesh: Any, spec: Tuple[Axes, ...]) -> "Sharding":
        return cls(mesh, tuple(spec), placements(spec, mesh))

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` leaf."""
        return tuple(compute_local_shape_and_global_offset(shape, self.mesh, self.placements)[0])


@dataclasses.dataclass(frozen=True)
class ShardedStruct:
    """A placed leaf described, not allocated: the counterpart of
    ``jax.ShapeDtypeStruct(shape, dtype, sharding=...)``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Sharding

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return self.sharding.local_shape(self.shape)

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * self.dtype.itemsize


def sharded_struct(struct, logical, rules: Dict[str, Axes], mesh: Any) -> ShardedStruct:
    """A :class:`ShardedStruct` for ``struct`` (anything with ``shape`` and
    ``dtype``) from its logical spec."""
    spec = resolve(tuple(struct.shape), logical, rules, axes(mesh))
    return ShardedStruct(tuple(struct.shape), struct.dtype, Sharding.of(mesh, spec))


def _map_leaves(fn: Callable, struct_tree, logical_tree):
    """``fn(leaf, logical)`` over the leaves of ``struct_tree`` (anything
    with ``shape``), zipped with ``logical_tree`` (the same dicts and lists,
    a tuple of logical names at each leaf); a module tree with ``tree()``
    (a ``ParamTree``) is walked as its nested dict."""
    if hasattr(struct_tree, "shape"):
        return fn(struct_tree, logical_tree)
    if hasattr(struct_tree, "tree"):
        struct_tree = struct_tree.tree()
    if isinstance(struct_tree, dict):
        return {k: _map_leaves(fn, v, logical_tree[k]) for k, v in struct_tree.items()}
    if isinstance(struct_tree, (list, tuple)):
        return type(struct_tree)(_map_leaves(fn, v, l) for v, l in zip(struct_tree, logical_tree))
    raise TypeError(f"not a tree node: {type(struct_tree).__name__}")


def tree_sharded_structs(struct_tree, logical_tree, rules, mesh):
    """Zip a tree of leaves with its logical-axis tree into ShardedStructs."""
    return _map_leaves(lambda s, l: sharded_struct(s, l, rules, mesh), struct_tree, logical_tree)


def tree_shardings(struct_tree, logical_tree, rules, mesh):
    """The :class:`Sharding` of every leaf."""
    return _map_leaves(lambda s, l: sharded_struct(s, l, rules, mesh).sharding, struct_tree, logical_tree)
