"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import ModelConfig
from . import (  # noqa: F401 — imported for registration side effect below
    gemma_7b,
    grok_1_314b,
    jamba_v0_1_52b,
    mamba2_370m,
    mistral_large_123b,
    musicgen_large,
    nemotron3_nano_30b_a3b,
    qwen2_vl_2b,
    qwen3_1_7b,
    qwen3_moe_235b_a22b,
    starcoder2_7b,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        jamba_v0_1_52b,
        qwen3_1_7b,
        mistral_large_123b,
        starcoder2_7b,
        gemma_7b,
        qwen3_moe_235b_a22b,
        grok_1_314b,
        qwen2_vl_2b,
        musicgen_large,
        mamba2_370m,
    )
}


# configurations of the port alone: the reference has no such model, and
# ``ARCHS`` stays the reference's list
PORT_ONLY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (nemotron3_nano_30b_a3b,)}


def arch_names() -> List[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    """An architecture of ``ARCHS`` or of ``PORT_ONLY``."""
    known = {**ARCHS, **PORT_ONLY}
    if name not in known:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(known)}")
    return known[name]


def reduced_config(name: str) -> ModelConfig:
    """Same family, tiny dims: one cycle of layers, d_model 64, 4 heads,
    vocab 512, ≤4 experts — per-arch smoke tests run this on CPU. All
    family-defining features (qk-norm, GeGLU, M-RoPE, MoE, SSD, hybrid
    interleave) are preserved."""
    cfg = get_config(name)
    n_experts = min(cfg.n_experts, 4) if cfg.n_experts else 0
    head_dim = (
        (32 if cfg.head_dim > cfg.d_model // max(cfg.n_heads, 1) else 16)
        if cfg.n_heads
        else 0
    )
    half = head_dim // 2
    t_sec = max(half // 4, 1)
    h_sec = (half - t_sec) // 2
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-reduced",
        n_layers=cfg.cycle_len,
        d_model=64,
        vocab_size=512,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(4 if cfg.n_kv_heads == cfg.n_heads else 2) if cfg.n_heads else 0,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_experts=n_experts,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        mrope_sections=(t_sec, h_sec, half - t_sec - h_sec) if half else cfg.mrope_sections,
    )
