"""Error-feedback int8 gradient compression [1-bit Adam / EF-SGD lineage;
Seide et al. 2014, arXiv:2102.02888]: the torch counterpart of
``repro.optim.compress``.

Each leaf of (grads + carried error) is quantized to int8 with a per-leaf
absmax scale; the quantization residual is the new error, so the
*accumulated* update stays unbiased. Trees are flat ``{name: tensor}``
dicts, as in ``optim.adamw``.

    grads_q, err = compress_with_feedback(grads, err)
    # all-reduce grads_q.payload (int8) + scale, then
    grads = decompress(grads_q)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

_F32 = torch.float32
Tree = Dict[str, torch.Tensor]


class Compressed(NamedTuple):
    payload: Tree  # int8 per leaf
    scale: Tree  # f32 scalar per leaf


def init_error(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=_F32, device=p.device) for k, p in params.items()}


def compress_with_feedback(grads: Tree, error: Tree) -> Tuple[Compressed, Tree]:
    """Quantize (grads + carried error) to int8; the new error is the
    residual."""
    payload, scale, new_error = {}, {}, {}
    for k, g in grads.items():
        x = g.to(_F32) + error[k]
        s = torch.clamp(x.abs().max() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        payload[k], scale[k], new_error[k] = q, s, x - q.to(_F32) * s
    return Compressed(payload, scale), new_error


def decompress(c: Compressed) -> Tree:
    return {k: q.to(_F32) * c.scale[k] for k, q in c.payload.items()}
