"""Batched serving: prefill → greedy decode with a fixed-capacity
cache; the torch counterpart of ``repro.launch.serve``.

Runs eagerly under ``torch.inference_mode()`` on the device of the model's
parameters (the reference jits both steps). ``generate`` with
``RunFlags(attn_impl="kernel")`` sends every prefill attention through the
CUDA flash-attention kernel on the card (its plain version on the CPU);
``ssd_impl="kernel"`` every Mamba-2 prefill SSD through the CUDA SSD kernel,
and ``norm_impl="kernel"`` every RMSNorm of prefill and decode through the
CUDA RMSNorm kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import Model, RunFlags
from ..train.step import make_decode_step, make_prefill_step


def extend_cache(cfg: ModelConfig, cache: List[dict], max_len: int) -> List[dict]:
    """Pad each attention layer's KV from the prefill length S to the
    serving capacity ``max_len``: a new zeroed buffer of that length with
    the prefill's KV in its first S positions. A Mamba-2 layer's cache (conv
    window, SSM state) has a fixed size and passes through as it is: the
    same dict, which decode then updates in place."""
    out = []
    for i, c in enumerate(cache):
        if cfg.block_kinds[i % cfg.cycle_len] != "attn":
            out.append(c)
            continue
        b, s = c["k"].shape[:2]
        if max_len < s:
            raise ValueError(f"capacity {max_len} is below the prefill length {s}")
        new = {}
        for key, t in c.items():
            new[key] = torch.zeros((b, max_len) + tuple(t.shape[2:]), dtype=t.dtype, device=t.device)
            new[key][:, :s] = t
        out.append(new)
    return out


def generate(
    params: Model,
    cfg: ModelConfig,
    prompt: Dict[str, torch.Tensor],
    n_tokens: int,
    max_len: Optional[int] = None,
    flags: RunFlags = RunFlags(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy generation. prompt: {'tokens': (B, S)} (or 'embeds'), on the
    parameters' device. Returns (generated (B, n_tokens), the logits (B, V)
    of the last step). Each decode step writes its KV (or its Mamba-2 conv
    window and SSM state) into the cache in place. ``n_tokens=0`` runs the prefill and cache extension only and
    returns (B, 0) tokens with the prefill's logits."""
    dev = params.device
    for key, t in prompt.items():
        if t.device != dev:
            raise ValueError(f"prompt[{key!r}] is on {t.device}, the model on {dev}")
    prefill = make_prefill_step(cfg, flags)
    decode = make_decode_step(cfg, flags)
    first = prompt["tokens"] if cfg.input_mode == "tokens" else prompt["embeds"]
    bsz, s0 = first.shape[0], first.shape[1]
    max_len = max_len or (s0 + n_tokens)
    with torch.inference_mode():
        logits, cache = prefill(params, prompt)
        cache = extend_cache(cfg, cache, max_len)
        outs = []
        tok = logits.argmax(-1)  # (B,)
        for i in range(n_tokens):
            outs.append(tok)
            if cfg.input_mode == "tokens":
                batch = {"tokens": tok[:, None]}
            else:
                # embedding-input archs decode from the embedding of the token
                batch = {"embeds": torch.zeros((bsz, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)}
            logits, cache = decode(params, cache, batch, s0 + i)
            tok = logits.argmax(-1)
        if not outs:
            return torch.empty((bsz, 0), dtype=torch.long, device=dev), logits
        return torch.stack(outs, 1), logits
