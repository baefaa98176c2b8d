"""NVIDIA Nemotron 3 Nano 30B-A3B [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16,
config.json, model type ``nemotron_h``]. A port-only configuration: the
reference package has no such model, so it is not in ``registry.ARCHS``
(which mirrors the reference's) but in ``registry.PORT_ONLY``.

52 layers of width 2,688 in the published ``hybrid_override_pattern``
``MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME``: 23 Mamba-2 layers
(M), 23 MoE layers (E) and 6 attention layers (*). Every layer is one mixer
with its own RMSNorm and residual, so an M or * position has no channel
mixer and an E position no sequence mixer (block kind ``"none"``).

  * Mamba-2: 64 heads of 64 (d_inner 4,096, given by the heads, not by
    ``expand`` x hidden), 8 groups (each B and C shared by 8 heads), state
    128, conv width 4 with bias, chunk 128 (``RunFlags.ssd_chunk``), the
    gated RMSNorm over each group's 512 channels;
  * MoE: 128 routed experts, top 6, routed by sigmoid scores plus the
    ``e_score_correction_bias``; the gates are the raw scores renormalised
    over the 6 and scaled by ``routed_scaling_factor`` 2.5; each expert
    ``down(relu(up x)^2)`` of width 1,856, and one shared expert of width
    3,712 on every token;
  * attention: 32 q heads and 2 KV heads of 128, no qk-norm, no rotary
    embedding (the release's attention applies none; ``rope_theta`` is in
    its config but unused);
  * vocabulary 131,072, untied embedding, norm eps 1e-5.

Departures, all the port's layout: RMSNorm scales applied as 1 + w; a MoE
layer keeps the port's static capacity ceil(T k 1.25 / E) (the release
routes without drops). ``n_group`` 1 / ``topk_group`` 1 make the release's
group-limited routing the plain top 6 over all experts.
"""
from .base import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
_BLOCK = {"M": "mamba", "E": "none", "*": "attn"}
_MLP = {"M": "none", "E": "moe", "*": "none"}

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b",
    n_layers=len(PATTERN),
    d_model=2688,
    vocab_size=131072,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    rope_kind="none",
    rope_theta=10000.0,
    d_ff=1856,
    mlp_kind="relu2",
    n_experts=128,
    top_k=6,
    moe_d_ff=1856,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv_width=4,
    block_kinds=tuple(_BLOCK[c] for c in PATTERN),
    mlp_kinds=tuple(_MLP[c] for c in PATTERN),
    norm_eps=1e-5,
    subquadratic=True,
    ssm_heads=64,
    ssm_groups=8,
    moe_router="sigmoid",
    moe_routed_scale=2.5,
    moe_shared_d_ff=3712,
)
