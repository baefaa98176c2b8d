"""Logical sharding axes for every parameter / cache / input tensor: the
torch counterpart of the reference's ``repro.sharding.specs``.

Every tensor dim gets a *logical* name; ``rules.py`` maps logical names to
mesh axes and resolves conflicts/divisibility per-array. This is the
MaxText-style logical-axis-rules pattern — and the substrate FARSI's
``migrate`` move mutates when auto-tuning the distribution (launch/autotune).

The trees mirror the reference's ``init_params`` layout: ``layers`` is a
list over cycle positions and each of its leaves carries a leading
``"layers"`` (stacking) axis. The port's model holds one entry per layer
instead; layer ``i``'s parameter has the logical axes of position
``i % cycle_len`` without that leading axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..configs.base import ModelConfig

L = Tuple[Optional[str], ...]  # logical axes of one array


def _attn_logical(cfg: ModelConfig) -> Dict[str, L]:
    p: Dict[str, L] = {
        "wq": ("embed", "qkv"),
        "wk": ("embed", "kv_qkv"),
        "wv": ("embed", "kv_qkv"),
        "wo": ("qkv", "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _mamba_logical(cfg: ModelConfig) -> Dict[str, L]:
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_conv"),
        "conv_b": ("ssm_conv",),
        "a_log": (None,),
        "d_skip": (None,),
        "dt_bias": (None,),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _mlp_logical(cfg: ModelConfig) -> Dict[str, L]:
    p: Dict[str, L] = {"wi_gate": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.mlp_kind != "gelu":
        p["wi_up"] = ("embed", "mlp")
    return p


def _moe_logical(cfg: ModelConfig) -> Dict[str, L]:
    return {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "expert_mlp"),
        "wi_up": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }


def _stacked(node):
    """Every leaf (a logical tuple) with the stacking axis prepended."""
    if isinstance(node, dict):
        return {k: _stacked(v) for k, v in node.items()}
    return ("layers",) + node


def param_logical(cfg: ModelConfig) -> Dict[str, Any]:
    """Mirror of ``models.model.init_params`` with logical names per dim.
    Stacked per-cycle leaves get a leading 'layers' axis."""
    layers = []
    for pos in range(cfg.cycle_len):
        kind = cfg.block_kinds[pos]
        p: Dict[str, Any] = {"norm1": (None,)}
        p["mixer"] = _attn_logical(cfg) if kind == "attn" else _mamba_logical(cfg)
        mk = cfg.mlp_kind_at(pos)
        if mk == "dense":
            p["norm2"] = (None,)
            p["mlp"] = _mlp_logical(cfg)
        elif mk == "moe":
            p["norm2"] = (None,)
            p["mlp"] = _moe_logical(cfg)
        layers.append(_stacked(p))
    out: Dict[str, Any] = {"layers": layers, "final_norm": (None,)}
    if cfg.input_mode == "tokens":
        # the token-gather dim must never shard (SPMD turns a gather over a
        # sharded dim into a full all-gather of the table); D shards FSDP-style
        out["embed"] = ("vocab_table", "embed")
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        out["lm_head"] = ("embed", "vocab")
    return out


def cache_logical(cfg: ModelConfig, kv_quant: str = "none") -> tuple:
    caches = []
    for kind in cfg.block_kinds:
        if kind == "attn":
            # kv_heads shards over 'model' when divisible; otherwise the
            # resolver falls through to head_dim (split-contraction decode)
            spec = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
            if kv_quant == "int8":
                sspec = ("layers", "batch", "cache_seq", "kv_heads")
                caches.append({"k": spec, "v": spec, "k_scale": sspec, "v_scale": sspec})
                continue
            caches.append({"k": spec, "v": spec})
        else:
            caches.append(
                {
                    "conv": ("layers", "batch", None, "ssm_conv"),
                    "ssm": ("layers", "batch", "ssm_heads", None, None),
                }
            )
    return tuple(caches)


def batch_logical(cfg: ModelConfig, kind: str) -> Dict[str, L]:
    """Input batch tensors for train/prefill ('seq' length S) or decode (S=1)."""
    out: Dict[str, L] = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = ("batch", "seq")
    else:
        out["embeds"] = ("batch", "seq", "act_embed")
    if kind == "train":
        out["labels"] = ("batch", "seq")
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = (None, "batch", "seq")
    return out
