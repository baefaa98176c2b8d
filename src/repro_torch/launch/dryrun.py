"""Multi-pod dry run: the torch counterpart of ``repro.launch.dryrun``.
Shows that every (arch × shape × mesh) cell places, shards and runs its
step on the production meshes, and records per device what it holds, what
it computes and what it sends over the links.

The reference forces 512 fake host devices and lowers and compiles each
cell. The port runs the cell's step itself, on meta tensors, under the
``fake`` process group at world 256 (16×16) or 512 (2×16×16): every leaf
is a ``DTensor`` whose local shard is a meta tensor of this device's shape
(``ShardedStruct.local_shape``), so nothing is allocated, no card is
needed, and the collectives DTensor issues run on the fake group, which
moves nothing. ``roofline.hlo.StepCounter`` watches the step on the local
shards. ``main`` starts the fake group in its own process, as the
reference sets ``XLA_FLAGS`` before JAX starts; tests start it in-process
(:func:`fake_world`). A process holds one default group.

The record keeps the reference's keys where the meaning holds:

  * ``memory``: ``argument_bytes`` (the local bytes of the step's
    arguments: the state, or the parameters and the decode cache, and the
    batch), ``output_bytes``, ``alias_bytes`` (output bytes that reuse an
    argument's storage: the state updated in place, the cache), and
    ``temp_bytes`` (the most bytes live during the step beyond the
    arguments). There is no ``code_bytes``: the port compiles no program
    for a step (its CUDA kernels are built once, outside any step);
  * ``cost``: ``flops`` and ``bytes accessed`` (``roofline.hlo``: op by op,
    unfused, so never compared with XLA's);
  * ``collectives``: ``roofline.hlo.collective_bytes``, the reference's
    dict, ``collectives_by_part`` (forward, backward, update) and
    ``collectives_by_op``, every issuer, the most bytes first
    (``roofline.hlo.collective_bytes_by_op``: the op and the port's
    function that sent them; the CLI prints the top :data:`BY_OP_TOP`);
  * ``trace_s`` in place of ``lower_s`` and ``compile_s``: the seconds the
    step took on the host;
  * ``kernels``: the flash kernel's calls (``DistConfig(attn_impl=
    "kernel")`` cells; its wrapper's meta path);
  * ``error`` and ``traceback`` where the cell failed.

The mesh's device type is ``"cuda"`` unless the caller asks for ``"cpu"``
(``--device cpu``, the port's one flag beyond the reference's CLI, for a
machine with no card). Placements and collectives do not depend on it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k --cycles 1

:func:`layout_bars` holds a one-cycle train cell (``--cycles 1``) to the
reference's compiled dry run of the same cell (``tests/gen_ref_dryrun.py``
writes it): the bars that ``tests/test_torch_layout*.py`` and
``chip_smoke.py``'s ``dryrun`` phase apply.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Union

import torch
import torch.distributed as torch_dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..configs.registry import arch_names, get_config
from ..models.model import RunFlags, init_cache, init_params
from ..optim.adamw import AdamWConfig
from ..roofline.hlo import (
    StepCounter,
    collective_bytes,
    collective_bytes_by_op,
    collective_bytes_per_computation,
    collective_counts,
)
from ..runtime.elastic import place, reshard_state, state_shardings
from ..sharding.act import activation_rules
from ..sharding.rules import DistConfig, Sharding, default_rules, tree_shardings
from ..sharding.specs import batch_logical, cache_logical, named_param_logical
from ..train.step import init_train_state, make_decode_step, make_prefill_step, make_train_step
from .mesh import make_production_mesh

MESHES = {False: "16x16", True: "2x16x16"}
BY_OP_TOP = 10  # issuers printed of a record's collectives_by_op
WORLDS = {False: 256, True: 512}


@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """The ``fake`` process group at ``world`` processes, this one rank 0,
    for the extent of the block; destroyed at its end."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch_dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        torch_dist.destroy_process_group()


def _batch_structs(cfg: ModelConfig, shape: ShapeConfig, device="meta", seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The global batch in the reference's dtypes: empty on meta; elsewhere
    tokens and labels drawn from ``seed``, positions 0…S-1 (the same on
    every rank)."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    meta = torch.device(device).type == "meta"
    gen = torch.Generator().manual_seed(seed)

    def ints(shape_):
        if meta:
            return torch.empty(shape_, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shape_, generator=gen, dtype=torch.int32).to(device)

    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = ints((b, s))
    elif meta:
        out["embeds"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=device)
    else:
        out["embeds"] = torch.randn((b, s, cfg.d_model), generator=gen).to(device, torch.bfloat16)
    if shape.kind == "train":
        out["labels"] = ints((b, s))
    if cfg.rope_kind == "mrope":
        pos = torch.arange(s, dtype=torch.int32, device=device)
        out["mrope_positions"] = pos.expand(3, b, s).contiguous()
    return out


def meta_place(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """``t``'s global shape placed with ``sharding``: a DTensor whose local
    shard is an empty meta tensor of this device's shape."""
    local = torch.empty(sharding.local_shape(tuple(t.shape)), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _placer(device) -> Callable[[torch.Tensor, Sharding], torch.Tensor]:
    return meta_place if torch.device(device).type == "meta" else place


def _place_tree(tree, shardings, placer):
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k], placer) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(v, s, placer) for v, s in zip(tree, shardings)]
    return placer(tree, shardings)


def _params(cfg: ModelConfig, rules, mesh, device, seed: int):
    """bf16 serving parameters, placed."""
    params = init_params(cfg, seed, dtype=torch.bfloat16, device=device)
    sh = tree_shardings(dict(params.named_parameters()), named_param_logical(cfg), rules, mesh)
    return params.map(lambda n, p: _placer(device)(p, sh[n]))


def _cache(cfg: ModelConfig, shape: ShapeConfig, dist: DistConfig, mesh, device):
    """The decode cache, one dict a layer, placed by the reference's cache
    specs without their stacking axis (layer i: cycle position i % len)."""
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, torch.bfloat16, dist.kv_quant,
                       device=device)
    stacked = cache_logical(cfg, dist.kv_quant)
    logical = [{k: v[1:] for k, v in stacked[i % cfg.cycle_len].items()} for i in range(cfg.n_layers)]
    return _place_tree(cache, tree_shardings(cache, logical, dist.rules, mesh), _placer(device))


def run_flags(dist: DistConfig, kind: str) -> RunFlags:
    """The ``RunFlags`` a cell's step runs with: the reference's mapping
    from its ``DistConfig`` (RMSNorm and SSD stay plain: no ``DistConfig``
    field reaches their kernels)."""
    return RunFlags(
        attn_impl=dist.attn_impl,
        q_block=dist.q_block,
        kv_block=dist.kv_block,
        remat=dist.remat if kind == "train" else "none",
        ssd_chunk=dist.ssd_chunk,
        moe_impl=dist.moe_impl,
    )


def build_cell(
    arch: Union[str, ModelConfig],
    shape_name: Union[str, ShapeConfig],
    multi_pod: bool,
    dist: Optional[DistConfig] = None,
    *,
    mesh=None,
    device_type: str = "cuda",
    device="meta",
    seed: int = 0,
):
    """Returns (step_fn, args tuple of placed DTensors, mesh, kind, dist).
    ``arch`` and ``shape_name`` may be configs; ``mesh`` defaults to the
    production mesh of ``multi_pod`` over ``device_type`` (a process group
    of its world must be running). On ``device`` "meta" (the dry run) the
    local shards are empty; on a real device the state comes from
    ``seed`` and is placed by ``runtime.elastic.place``, so that a real
    step of the same cell can be held against the dry run."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if not shape_applicable(cfg, shape):
        raise ValueError(f"{cfg.name} × {shape.name}: inapplicable (see DESIGN.md)")
    if dist is not None and dist.capacity_factor > 0:
        cfg = dataclasses.replace(cfg, capacity_factor=dist.capacity_factor)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    rules = dict(default_rules(cfg, shape, mesh))
    # deeper grad accumulation for ≥50B-param models: the remat-residual
    # stack scales with tokens/device × depth (see DistConfig.microbatches)
    default_micro = 8 if cfg.param_counts()["total"] >= 50e9 else 4
    if dist is None:
        dist = DistConfig(rules=rules, microbatches=default_micro)
    else:
        dist = dist.replace(rules={**rules, **dist.rules})
    flags = run_flags(dist, shape.kind)
    batch_t = _batch_structs(cfg, shape, device, seed)
    batch = _place_tree(batch_t, tree_shardings(batch_t, batch_logical(cfg, shape.kind), dist.rules, mesh),
                        _placer(device))
    if shape.kind == "train":
        state = init_train_state(cfg, seed, device=device)
        state = reshard_state(state, state_shardings(cfg, shape, mesh, state, dist.rules),
                              placer=_placer(device))
        fn = make_train_step(cfg, flags, AdamWConfig(), microbatches=dist.microbatches)
        args = (state, batch)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, flags)
        args = (_params(cfg, dist.rules, mesh, device, seed), batch)
    else:  # decode: the cache is updated in place (the reference donates it)
        fn = make_decode_step(cfg, flags)
        args = (_params(cfg, dist.rules, mesh, device, seed), _cache(cfg, shape, dist, mesh, device),
                batch, shape.seq_len - 1)
    return fn, args, mesh, shape.kind, dist


def _local_storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the local shards of every tensor in ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            st = local.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def local_bytes(tree) -> int:
    """The local bytes of every tensor in ``tree`` (a storage its views
    share counted once)."""
    return sum(_local_storages(_flat(tree)).values())


def _flat(tree):
    """A tree with every ``Model`` as its dict of parameters."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flat(v) for v in tree]
    return tree


def run_step(fn, args, kind: str, mesh, rules) -> Dict[str, Any]:
    """One step under ``activation_rules`` and a :class:`StepCounter`
    (autograd on for a train step, off for serving): the record's
    ``memory``, ``cost``, ``collectives``, ``collectives_by_part``,
    ``collectives_by_op``,
    ``trace_s`` and ``kernels``."""
    counter = StepCounter()
    counter.hold(_flat(args))
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    t0 = time.perf_counter()
    with activation_rules(rules, mesh), grad, counter:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    arg_st, out_st = _local_storages(_flat(args)), _local_storages(_flat(out))
    totals = counter.totals()
    return {
        "memory": {
            "argument_bytes": sum(arg_st.values()),
            "output_bytes": sum(out_st.values()),
            "temp_bytes": counter.peak_bytes,
            "alias_bytes": sum(n for k, n in out_st.items() if k in arg_st),
        },
        "cost": {"flops": float(totals["flops"]), "bytes accessed": float(totals["bytes_accessed"])},
        "collectives": collective_bytes(counter),
        "collective_counts": collective_counts(counter),
        "collectives_by_part": collective_bytes_per_computation(counter),
        "collectives_by_op": collective_bytes_by_op(counter),
        "trace_s": trace_s,
        "kernels": {"flash": counter.flash_calls},
    }


def run_cell(
    arch: Union[str, ModelConfig],
    shape_name: Union[str, ShapeConfig],
    multi_pod: bool,
    dist: Optional[DistConfig] = None,
    verbose: bool = True,
    *,
    mesh=None,
    device_type: str = "cuda",
) -> Dict[str, Any]:
    """The cell's record (module docstring); never raises for a fault of
    the cell, which is recorded under ``error`` and ``traceback``."""
    rec: Dict[str, Any] = {
        "arch": arch if isinstance(arch, str) else arch.name,
        "shape": shape_name if isinstance(shape_name, str) else shape_name.name,
        "mesh": MESHES[multi_pod] if mesh is None else "x".join(map(str, mesh.shape)),
        "ok": False,
    }
    try:
        fn, args, mesh, kind, dist = build_cell(arch, shape_name, multi_pod, dist, mesh=mesh,
                                                device_type=device_type)
        rec.update(run_step(fn, args, kind, mesh, dist.rules))
        if verbose:
            print(f"  memory: {rec['memory']}")
            print(f"  cost: {rec['cost']}")
            print(f"  collectives: {rec['collectives']}")
            for issuer, row in list(rec["collectives_by_op"].items())[:BY_OP_TOP]:
                print(f"    {row['bytes']:>16,d} B in {row['count']:>6d} ops  {issuer}")
        rec["ok"] = True
    except Exception as e:  # a failing cell is a result, recorded with its traceback
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    return rec


# ---------------------------------------------------------------------------
# the layout bars: a one-cycle train cell against the reference's compiled step
# ---------------------------------------------------------------------------
TEMP_X = 2.0  # temp bytes a device ≤ 2 × the reference's compiled temp
FLOPS_X = 2.0  # flops a device ≤ 2 × roofline.analytic.step_costs'
ICI_X = 10.0  # collective bytes ≤ max(10 × step_costs' ICI bytes, a quarter of the before)
BEFORE_SHARE = 0.25
AFTER_X = 1.5  # collective bytes ≤ 1.5 × those of the layout that met these bars first
GROWTH_X = 1.5  # temp bytes a cycle adds ≤ 1.5 × the argument bytes it adds
CARD_BYTES = 80e9  # an H100's memory: a device's arguments + temps at full depth
# the stacks depth_bars holds: a cycle's parameters and moments outweigh the
# activations it saves for its recompute (in the small stacks they do not:
# qwen2-vl-2b's second cycle adds 14.9 MB of temps to 2.8 MB of arguments),
# and each of them needed more than a card before its layout followed the
# reference's
DEPTH_ARCHS = ("mistral-large-123b", "jamba-v0.1-52b", "grok-1-314b", "qwen3-moe-235b-a22b")


def cut(cfg: ModelConfig, cycles: int) -> ModelConfig:
    """``cfg`` cut to ``cycles`` layer cycles (0: as it is)."""
    return dataclasses.replace(cfg, n_layers=cycles * cfg.cycle_len) if cycles else cfg


def layout_bars(rec: Dict[str, Any], ref: Dict[str, Any], before: Dict[str, Any], after: Dict[str, Any],
                cfg: ModelConfig, shape: ShapeConfig, mesh: Dict[str, int]) -> Dict[str, Dict[str, Any]]:
    """The port's record ``rec`` of a train cell held to the reference's
    compiled record ``ref`` of the same cell (``tests/data/
    ref_dryrun_train_4k.json``), to ``before``, the port's own numbers
    before the layout followed the reference's, and to ``after``, those of
    the layout that first met these bars (``tests/data/port_dryrun_*.json``:
    ``temp_bytes``, ``flops``, ``collective_bytes``): argument bytes equal
    the reference's; temp bytes at most :data:`TEMP_X` × the reference's and
    no more than before; flops at most :data:`FLOPS_X` × the analytic step
    model's and no more than before; collective bytes at most
    max(:data:`ICI_X` × the model's ICI bytes, :data:`BEFORE_SHARE` ×
    before), no more than before and at most :data:`AFTER_X` × after.
    ``mesh``: {"data": n, "model": m}. Each entry: ``value``, ``bar``,
    ``ok``."""
    from ..roofline.analytic import MeshShape, step_costs

    ops = step_costs(cfg, shape, MeshShape(mesh["data"], mesh["model"]))
    flops, ici = sum(o.flops for o in ops), sum(o.ici_bytes for o in ops)
    got = {"argument_bytes": rec["memory"]["argument_bytes"], "temp_bytes": rec["memory"]["temp_bytes"],
           "flops": rec["cost"]["flops"], "collective_bytes": rec["collectives"]["total"]}
    bars = {"temp_bytes": min(TEMP_X * ref["memory"]["temp_bytes"], before["temp_bytes"]),
            "flops": min(FLOPS_X * flops, before["flops"]),
            "collective_bytes": min(max(ICI_X * ici, BEFORE_SHARE * before["collective_bytes"]),
                                    before["collective_bytes"], AFTER_X * after["collective_bytes"])}
    out = {"argument_bytes": {"value": got["argument_bytes"], "bar": ref["memory"]["argument_bytes"],
                              "ok": got["argument_bytes"] == ref["memory"]["argument_bytes"]}}
    for key, bar in bars.items():
        out[key] = {"value": got[key], "bar": bar, "ok": got[key] <= bar}
    return out


def depth_bars(one: Dict[str, Any], two: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Dict[str, Any]]:
    """What a layer cycle adds, from the records of a train cell cut to one
    and to two cycles (``cfg``: the full-depth config): ``temp_growth``,
    the temp bytes the second cycle adds, at most :data:`GROWTH_X` × the
    argument bytes it adds (its parameters and moments, 12 bytes a local
    parameter: a cycle's gradients and update temporaries are of that
    size, while a weight gathered over a 16-way data axis and kept to the
    next cycle is 16 × its shard, 32 bytes a local parameter even in bf16);
    ``full_depth``, the arguments and temps of the full stack extrapolated
    by that growth, at most :data:`CARD_BYTES`. Each entry: ``value``,
    ``bar``, ``ok``."""
    arg1, arg2 = one["memory"]["argument_bytes"], two["memory"]["argument_bytes"]
    temp1, temp2 = one["memory"]["temp_bytes"], two["memory"]["temp_bytes"]
    more = cfg.n_layers // cfg.cycle_len - 1
    full = arg1 + temp1 + more * (arg2 - arg1 + temp2 - temp1)
    return {"temp_growth": {"value": temp2 - temp1, "bar": GROWTH_X * (arg2 - arg1),
                            "ok": temp2 - temp1 <= GROWTH_X * (arg2 - arg1)},
            "full_depth": {"value": full, "bar": CARD_BYTES, "ok": full <= CARD_BYTES}}


def iter_cells(multi_pod: bool):
    for arch in arch_names():
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if shape_applicable(cfg, shape):
                yield arch, shape_name, multi_pod


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON records")
    # tuned-config knobs (§Perf reproducibility from the CLI)
    ap.add_argument("--moe-impl", choices=("dense", "shard_map"), default="dense")
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none")
    ap.add_argument("--remat", choices=("full", "none", "dots"), default="full")
    ap.add_argument("--microbatches", type=int, default=0, help="0 = per-arch default")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (the tensors are meta either way)")
    ap.add_argument("--cycles", type=int, default=0,
                    help="cut each model to this many layer cycles at full width (0: full depth)")
    args = ap.parse_args(argv)

    dist = None
    if (
        args.moe_impl != "dense"
        or args.kv_quant != "none"
        or args.remat != "full"
        or args.microbatches
    ):
        dist = DistConfig(
            rules={},
            moe_impl=args.moe_impl,
            kv_quant=args.kv_quant,
            remat=args.remat,
            microbatches=args.microbatches or 4,
        )

    cells = (
        list(iter_cells(args.multi_pod))
        if args.all
        else [(args.arch, args.shape, args.multi_pod)]
    )
    n_ok = 0
    with fake_world(WORLDS[args.multi_pod]):
        for arch, shape_name, mp in cells:
            print(f"[dryrun] {arch} × {shape_name} × {MESHES[mp]}", flush=True)
            rec = run_cell(cut(get_config(arch), args.cycles) if args.cycles else arch, shape_name, mp, dist,
                           device_type=args.device)
            status = "OK" if rec["ok"] else f"FAIL: {rec.get('error')}"
            print(f"  -> {status}  (trace {rec.get('trace_s', 0):.1f}s)", flush=True)
            n_ok += rec["ok"]
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = f"{arch}_{shape_name}_{rec['mesh']}".replace("/", "-")
                with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=2, default=str)
    print(f"[dryrun] {n_ok}/{len(cells)} cells OK")
    if n_ok < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
