"""MusicGen-large [arXiv:2306.05284; hf:facebook/musicgen-large].

Decoder-only transformer over EnCodec tokens: 48L, d_model=2048, 32 heads
(kv=32 → MHA, head_dim 64), d_ff=8192, vocab=2048 (one EnCodec codebook).
The audio frontend (EnCodec + codebook delay interleave) is a stub —
``input_specs()`` provides precomputed frame embeddings (batch, seq, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    vocab_size=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    mlp_kind="gelu",  # MusicGen uses an ungated GELU FFN (d_ff = 4·d_model)
    rope_kind="none",  # musicgen uses learned sinusoidal offsets; stubbed NoPE
    input_mode="embeddings",
    block_kinds=("attn",),
    mlp_kinds=("dense",),
)
