"""Per-device f32 training-state bytes of a model cut to a few layers, on
the meshes of the port's sharded training, computed from the placements
alone: no device, no allocation. Each parameter's local shard (its
``sharding.rules.ShardedStruct`` under ``default_rules`` at the train_4k
shape) counts 16 bytes an element: the f32 master weight, its f32
gradient and the two AdamW moments. The meshes are built under the
``fake`` process group at their full world size.

  PYTHONPATH=src python examples/torch_state_bytes.py

prints one JSON line: {model: {mesh: {"params", "bytes_per_device",
"bytes_whole", "largest_leaf"}}} for one Jamba cycle (8 layers) and one
Grok-1 layer, on 2×2 and 16×16 ("data", "model") meshes.
"""
import dataclasses
import json

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.sharding.rules import default_rules, sharded_struct
from repro_torch.sharding.specs import named_param_logical

BYTES_PER_ELEMENT = 16  # f32 weight, gradient, first and second moment
MODELS = {"jamba-v0.1-52b": 8, "grok-1-314b": 1}  # layers kept: one Jamba cycle, one Grok-1 layer
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}


def param_shapes(cfg):
    """{parameter name: shape} of ``cfg``'s ``Model``, from a meta init."""
    from repro_torch.models.model import init_params

    model = init_params(cfg, seed=0, device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def state_bytes(cfg, mesh) -> dict:
    rules = default_rules(cfg, SHAPES["train_4k"], mesh)
    logical = named_param_logical(cfg)
    local, whole, n, largest = 0, 0, 0, ("", 0)
    for name, shape in param_shapes(cfg).items():
        st = sharded_struct(torch.empty(shape, device="meta"), logical[name], rules, mesh)
        b = st.local_nbytes // 4 * BYTES_PER_ELEMENT
        numel = 1
        for d in shape:
            numel *= d
        local, whole, n = local + b, whole + numel * BYTES_PER_ELEMENT, n + numel
        largest = max(largest, (name, b), key=lambda x: x[1])
    return {"params": n, "bytes_per_device": local, "bytes_whole": whole,
            "largest_leaf": {"name": largest[0], "bytes_per_device": largest[1]}}


def main() -> None:
    out = {}
    for arch, layers in MODELS.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        out[f"{arch} ({layers} layers)"] = {}
        for name, shape in MESHES.items():
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape[0] * shape[1])
            try:
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                out[f"{arch} ({layers} layers)"][name] = state_bytes(cfg, mesh)
            finally:
                dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
