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
and ``axis_names``; ``resolve`` returns the placement tuple (one entry per
dim: None, an axis name, or a tuple of names) that the reference wraps in
``PartitionSpec(*parts)``. Building shardings on a real mesh is not part of
this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

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
