"""Mamba2-370m [arXiv:2405.21060; hf:state-spaces/mamba2-370m; unverified].

Pure SSM (attention-free): 48L of Mamba-2 (SSD) blocks, d_model=1024,
d_inner=2048 (expand 2, head_dim 64 → 32 ssm heads), ssm_state=128,
vocab=50280, no separate FFN (d_ff=0). Sub-quadratic: runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    vocab_size=50280,
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_kind="none",
    tie_embeddings=True,
    block_kinds=("mamba",),
    mlp_kinds=("none",),
    subquadratic=True,
)
