"""Carry the reference's parameters into the port.

``params_from_reference(tree)`` takes the pytree of the reference's
``init_params`` with every leaf as a numpy array (``layers`` a list over
cycle positions, each leaf stacked over cycles; ``final_norm``, ``embed``,
``lm_head``) and returns the port's :class:`~repro_torch.models.model.Model`
holding the same values, one entry of ``layers`` per layer (layer
``c * cycle_len + pos`` is cycle ``c`` of position ``pos``). Both packages
then compute the same function on the same inputs. bf16 leaves (numpy
arrays of the ``bfloat16`` extension type) keep their bits.

``train_state_from_reference(state)`` does the same for the reference's
train state ``{params, opt: {m, v, count}, step}``: the moments go through
the same mapping and come out keyed by the port's parameter names, as
``optim.adamw`` keeps them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .model import Model, resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_reference(tree: Dict[str, Any], device=None) -> Model:
    """The port's model with the reference tree's values, on ``device``
    (CUDA by default)."""
    dev = resolve_device(device)
    positions = tree["layers"]
    n_cycles = len(next(iter(_leaves(positions[0]))))
    layers = [_map(positions[pos], lambda a, c=c: _tensor(a[c]))
              for c in range(n_cycles) for pos in range(len(positions))]
    top = {k: _tensor(v) for k, v in tree.items() if k != "layers"}
    return Model({"layers": layers, **top}).to(dev)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def train_state_from_reference(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's train state (``train.step.init_train_state``'s layout:
    parameters requiring grad, ``{name: f32 moment}`` dicts, int32 count and
    step) with the values of the reference's, every leaf a numpy array."""
    params = params_from_reference(state["params"], device).requires_grad_(True)
    dev = params.device

    def moments(tree):
        return {name: t.detach() for name, t in params_from_reference(tree, dev).named_parameters()}

    def scalar(a):
        return torch.tensor(np.array(a), dtype=torch.int32, device=dev)

    opt = state["opt"]
    return {"params": params,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]), "count": scalar(opt["count"])},
            "step": scalar(state["step"])}
