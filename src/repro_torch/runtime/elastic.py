"""Elastic scaling: re-map a training state onto a different mesh; the
torch counterpart of ``repro.runtime.elastic``.

Checkpoints are topology-free (the full tensor of every leaf), so
elasticity reduces to re-deriving placements for the *current* mesh from
the same logical rules and re-placing leaves. ``shrink_mesh`` proposes the
largest viable mesh from the surviving device count (keeping the model
axis intact first — TP degree is baked into layout efficiency; the data
axis absorbs losses, with the global batch re-split across fewer data
shards).

A train state is ``{params: Model, opt: {m, v, count}, step}``;
:func:`state_shardings` gives the same tree with a
``sharding.rules.Sharding`` at every leaf (``params`` flattened to the
parameter names, the keys of the moments), and :func:`reshard_state`
places every leaf with it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import ParamTree
from ..sharding.rules import Sharding, default_rules, tree_shardings
from ..sharding.specs import named_param_logical


def shrink_mesh(n_devices: int, model_axis: int = 16) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (data, model) mesh with data a power of two that fits
    ``n_devices``. Falls back to smaller model axes if necessary."""
    while model_axis > 1:
        if n_devices >= model_axis:
            data = 1
            while data * 2 * model_axis <= n_devices:
                data *= 2
            return (data, model_axis), ("data", "model")
        model_axis //= 2
    return (max(n_devices, 1), 1), ("data", "model")


def _flat_params(state: Dict[str, Any]) -> Dict[str, Any]:
    params = state["params"]
    if isinstance(params, ParamTree):
        return dict(params.named_parameters())
    return params


def state_shardings(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    state_struct: Dict[str, Any],
    rules: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Shardings for a {params, opt{m, v, count}, step} train state on
    ``mesh``: ``state_struct`` is the state or one of its shape (any leaves
    with ``shape``); ``params`` comes back keyed by parameter name."""
    rules = rules or default_rules(cfg, shape, mesh)
    p_logical = named_param_logical(cfg)
    struct = {"params": _flat_params(state_struct), "opt": state_struct["opt"],
              "step": state_struct["step"]}
    logical = {
        "params": p_logical,
        "opt": {"m": p_logical, "v": p_logical, "count": ()},
        "step": (),
    }
    return tree_shardings(struct, logical, rules, mesh)


def place(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``t`` placed with ``sharding``: a plain tensor (the full value, the
    same on every rank) is distributed; a DTensor on another mesh goes
    through its full tensor; one on the same mesh is redistributed."""
    if isinstance(t, DTensor):
        if t.device_mesh == sharding.mesh:
            return t.redistribute(sharding.mesh, sharding.placements)
        t = t.full_tensor()
    return distribute_tensor(t.detach().to(sharding.mesh.device_type), sharding.mesh,
                             sharding.placements)


def reshard_state(state: Dict[str, Any], shardings: Dict[str, Any],
                  placer: Callable[[torch.Tensor, Sharding], torch.Tensor] = place) -> Dict[str, Any]:
    """Re-place every leaf with its new sharding (across meshes through the
    full tensor), by ``placer`` (:func:`place`; the dry run places meta
    shards). The parameters come back as a ``Model`` of DTensor
    parameters, each keeping its ``requires_grad``."""
    params, named = state["params"], _flat_params(state)
    placed = {n: placer(p.detach(), shardings["params"][n]) for n, p in named.items()}
    model = params.map(lambda n, _: placed[n]) if isinstance(params, ParamTree) else placed
    opt = {key: {n: placer(t, shardings["opt"][key][n]) for n, t in state["opt"][key].items()}
           for key in ("m", "v")}
    opt["count"] = placer(state["opt"]["count"], shardings["opt"]["count"])
    return {"params": model, "opt": opt, "step": placer(state["step"], shardings["step"])}
