"""Model/architecture configuration.

One generic decoder stack instantiates every assigned architecture: layers are
grouped into a repeating *cycle* (so heterogeneous stacks like Jamba's 1:7
Mamba:attention interleave scan cleanly over cycles), and each cycle position
declares its sequence mixer ("attn" | "mamba" | "none") and its channel
mixer ("dense" | "moe" | "none"). A position whose sequence mixer is
"none" is a channel mixer alone, with one norm and one residual (the
Nemotron-H layout, where every layer holds one mixer).

Fields after ``subquadratic`` are the port's own (no field of the
reference's ``ModelConfig``); each defaults to the behaviour every
registered architecture has.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_kind: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # halves of head_dim
    # channel mixer
    d_ff: int = 0
    mlp_kind: str = "swiglu"  # "swiglu" | "geglu" | "gelu" | "relu2" (non-gated relu(x W)^2)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # Mamba-2 (SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    # stack layout: cycle of layer kinds + channel-mixer kinds
    block_kinds: Tuple[str, ...] = ("attn",)
    mlp_kinds: Tuple[str, ...] = ("dense",)
    # IO
    input_mode: str = "tokens"  # "tokens" | "embeddings" (vlm/audio stubs)
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # attention family (long_500k applicability; see DESIGN.md)
    subquadratic: bool = False
    # ---- port-only fields ----------------------------------------------
    # Mamba-2: heads given explicitly (0: ssm_expand * d_model / ssm_head_dim)
    # and SSM groups, each shared B and C for ssm_heads / ssm_groups heads;
    # the gated norm then runs over each group's channels
    ssm_heads: int = 0
    ssm_groups: int = 1
    # MoE router: "softmax" (top-k by probability, gates renormalised) or
    # "sigmoid" (top-k by sigmoid score + a learned correction bias, gates
    # the raw scores renormalised), the gates then times moe_routed_scale
    moe_router: str = "softmax"
    moe_routed_scale: float = 1.0
    # a shared expert of this width on every token of a MoE layer (0: none)
    moe_shared_d_ff: int = 0

    # ---- derived --------------------------------------------------------
    @property
    def cycle_len(self) -> int:
        return len(self.block_kinds)

    @property
    def n_cycles(self) -> int:
        assert self.n_layers % self.cycle_len == 0, (self.name, self.n_layers, self.cycle_len)
        return self.n_layers // self.cycle_len

    @property
    def ssm_d_inner(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_heads or self.ssm_d_inner // self.ssm_head_dim

    def mlp_kind_at(self, pos: int) -> str:
        return self.mlp_kinds[pos % len(self.mlp_kinds)]

    def has_attention(self) -> bool:
        return "attn" in self.block_kinds

    def has_mamba(self) -> bool:
        return "mamba" in self.block_kinds

    def has_moe(self) -> bool:
        return any(k == "moe" for k in self.mlp_kinds)

    # ---- parameter counting (roofline MODEL_FLOPS = 6·N·D) --------------
    def param_counts(self) -> Dict[str, float]:
        D = self.d_model
        per_pos_total = []
        per_pos_active = []
        for pos, kind in enumerate(self.block_kinds):
            # two rms norms (approx; mamba-only uses one); a mixer-less layer one
            p_tot = p_act = D if kind == "none" else 2 * D
            if kind == "none":
                pass
            elif kind == "attn":
                qkvo = D * self.n_heads * self.head_dim * 2 + D * self.n_kv_heads * self.head_dim * 2
                p_tot += qkvo
                p_act += qkvo
            else:  # mamba2
                d_in = self.ssm_d_inner
                nh = self.ssm_n_heads
                bc = 2 * self.ssm_groups * self.ssm_state
                proj = D * (2 * d_in + bc + nh) + d_in * D
                conv = (d_in + bc) * self.ssm_conv_width
                p_tot += proj + conv + 2 * nh + d_in
                p_act += proj + conv + 2 * nh + d_in
            mk = self.mlp_kind_at(pos)
            if mk == "dense":
                n_mats = 2 if self.mlp_kind == "gelu" else 3
                p_tot += n_mats * D * self.d_ff
                p_act += n_mats * D * self.d_ff
            elif mk == "moe":
                n_mats = 2 if self.mlp_kind == "relu2" else 3  # a GELU expert is gated
                f = self.moe_d_ff or self.d_ff
                router = D * self.n_experts + (self.n_experts if self.moe_router == "sigmoid" else 0)
                shared = n_mats * D * self.moe_shared_d_ff
                p_tot += router + self.n_experts * n_mats * D * f + shared
                p_act += router + self.top_k * n_mats * D * f + shared
            per_pos_total.append(p_tot)
            per_pos_active.append(p_act)
        body_tot = self.n_cycles * sum(per_pos_total)
        body_act = self.n_cycles * sum(per_pos_active)
        embed = self.vocab_size * D
        head = 0 if self.tie_embeddings else self.vocab_size * D
        return {
            "total": body_tot + embed + head + D,
            "active": body_act + embed + head + D,
            "embed": embed + head,
            "body": body_tot,
        }


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (SSM/hybrid only) — pure
    full-attention archs skip it (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
