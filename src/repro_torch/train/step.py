"""Serving step functions of the decoder: the torch counterparts of the
reference's ``make_prefill_step`` and ``make_decode_step``
(``repro.train.step``). Both compute in bf16. The training step comes with
the training slice (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models.model import Model, RunFlags, _head, _sequence, cast_params, norm_fn
from ..models.model import decode_step as model_decode


def make_prefill_step(cfg: ModelConfig, flags: RunFlags):
    def prefill_step(params: Model, batch: Dict[str, torch.Tensor]):
        """(last-position logits (B, V) f32, per-layer cache: KV or the
        Mamba-2 conv window and SSM state). The head runs on the last
        position only: it is row-wise, so those logits are the full
        forward's."""
        p = cast_params(params, torch.bfloat16)
        x, cache = _sequence(p, cfg, batch, flags, torch.bfloat16, True)
        return _head(p, cfg, x[:, -1:], norm_fn(flags))[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, flags: RunFlags):
    def decode_step(params: Model, cache, batch: Dict[str, torch.Tensor], cur_index: int):
        """(logits (B, V) f32, cache updated in place)."""
        logits, cache = model_decode(params, cfg, cache, batch, cur_index, flags,
                                     compute_dtype=torch.bfloat16)
        return logits[:, -1], cache

    return decode_step
