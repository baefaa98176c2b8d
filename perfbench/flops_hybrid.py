"""The yardstick's arithmetic for the hybrid Mamba-2 / MoE / attention stack
(Nemotron-H): the FLOPs a prefill request needs and the FLOPs and bytes of
one SSD call, counted from the configuration's widths alone.

Frozen beside ``flops.py``, whose ``param_counts`` counts attention and a
three-matrix MLP in every layer: nothing here reads a function of the port.
"""
from __future__ import annotations


def _kind(cfg, i: int) -> str:
    """A layer's letter: "M" (Mamba-2), "E" (MoE) or "*" (attention)."""
    if cfg.mlp_kinds[i % len(cfg.mlp_kinds)] == "moe":
        return "E"
    return "M" if cfg.block_kinds[i % len(cfg.block_kinds)] == "mamba" else "*"


def param_counts(cfg) -> dict:
    """{"active", "embed"}: the parameters a token uses (each MoE layer's
    router and its correction bias, its top-k routed experts at two
    matrices each and its shared expert; each Mamba-2 layer's in_proj, conv
    weight and bias, A, D, dt bias, gated-norm scale and out_proj; each
    attention layer's four projections; one norm scale of width D a layer
    and the final norm), and those of the embedding table and the untied
    head."""
    d = cfg.d_model
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    per = {
        "M": d + d * (d_in + conv_dim + cfg.ssm_heads) + (cfg.ssm_conv_width + 1) * conv_dim
        + 3 * cfg.ssm_heads + d_in + d_in * d,
        "E": d + d * cfg.n_experts + cfg.n_experts + cfg.top_k * 2 * d * cfg.moe_d_ff
        + 2 * d * cfg.moe_shared_d_ff,
        "*": d + 2 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim,
    }
    embed = 2 * cfg.vocab_size * d
    return {"active": sum(per[_kind(cfg, i)] for i in range(cfg.n_layers)) + d + embed, "embed": embed}


def ssd_cost(b: int, s: int, h: int, p: int, n: int, g: int, q: int, itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one SSD call at chunk q: inside each chunk the
    causal pairs' C·Bᵀ, once a group (2N a pair), and their product with
    x·dt, once a head (2P a pair); C·h and the state update, 4PN a token
    and head. x and y (H heads of P) and B and C (G groups of N) in
    ``itemsize`` bytes, dt in f32, each moved once, and the final state h
    (H, P, N) written once in f32."""
    chunks = s // q
    pairs = q * (q + 1) / 2
    ops = b * chunks * (g * pairs * 2 * n + h * pairs * 2 * p + h * 4 * q * p * n)
    nbytes = 2 * b * s * h * p * itemsize + 4 * b * s * h + 2 * b * s * g * n * itemsize + 4 * b * h * p * n
    return float(ops), float(nbytes)


def prefill_request_flops(cfg, batch: int, seq: int, chunk: int = 128) -> float:
    """FLOPs one prefill needs: 2 · the non-embedding active parameters ·
    tokens, the causal attention products of the attention layers (as
    ``flops.prefill_request_flops`` counts them), the SSD's chunked products
    of the Mamba-2 layers, and the head on the last position of each
    sequence; the embedding lookup is a gather and counts zero."""
    pc = param_counts(cfg)
    body = 2.0 * (pc["active"] - pc["embed"]) * batch * seq
    n_attn = sum(_kind(cfg, i) == "*" for i in range(cfg.n_layers))
    n_mamba = sum(_kind(cfg, i) == "M" for i in range(cfg.n_layers))
    attn = 4.0 * batch * seq * seq * cfg.n_heads * cfg.head_dim * n_attn / 2
    ssd_ops, _ = ssd_cost(batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, chunk)
    head = 2.0 * cfg.d_model * cfg.vocab_size * batch
    return body + attn + n_mamba * ssd_ops + head

