"""AdamW with global-norm clipping and a warmup + cosine schedule: the
torch counterpart of ``repro.optim.adamw``.

A tree here is a flat ``{name: tensor}`` dict (the model's
``named_parameters()``); the optimizer state holds one f32 moment per
parameter under the same names. :func:`update` steps the parameters and the
moments IN PLACE with ``torch._foreach_*`` ops (the reference returns new
trees, and its launcher donates the old ones), each op the reference's
f32 arithmetic in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

_F32 = torch.float32
Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), in f32."""
    step = step.to(_F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Tree) -> Dict[str, object]:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=_F32, device=p.device) for k, p in params.items()}

    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(), "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ over leaves of each leaf's f32 sum of squares)."""
    leaves = [x.to(_F32).square().sum() for x in tree.values()]
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def update(grads: Tree, state: Dict[str, object], params: Tree,
           cfg: AdamWConfig) -> Tuple[Tree, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step: clip ``grads`` to ``cfg.clip_norm`` by their global
    norm, update the moments and the parameters in place; returns
    (params, state, {"lr", "grad_norm"}), the first two the objects passed
    in. ``grads`` may be overwritten (they are scaled in place)."""
    count = state["count"] + 1
    lr = schedule(count, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    names = list(params)
    g = [grads[k].to(_F32) for k in names]
    torch._foreach_mul_(g, scale)
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2), g))
    cnt = count.to(_F32)
    bc1 = 1 - cfg.b1 ** cnt
    bc2 = 1 - cfg.b2 ** cnt
    # p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
    p = [params[k] for k in names]
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, cfg.eps)
    step = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    pf = [x.to(_F32) for x in p]
    torch._foreach_add_(step, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(step, lr)
    new = torch._foreach_sub(pf, step)
    for x, y in zip(p, new):
        x.copy_(y)
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm}
