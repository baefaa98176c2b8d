"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) on the CPU:

- the flash wrapper's meta path gives the plain path's output shapes and
  dtypes, saves the CUDA branch's (B, S, KH, G) f32 lse under autograd,
  differentiates through the plain backward on meta, and counts its calls;
- the reference test's two cells (``tests/test_dryrun_subprocess.py``),
  mamba2-370m × decode_32k × 16x16 and qwen2-vl-2b × decode_32k ×
  2x16x16, are ``ok`` in-process at full size, with the reference's record
  keys where the meaning holds;
- for every train_4k cell on 16x16, the arguments' local bytes equal the
  sum of ``ShardedStruct.local_nbytes`` over the state and batch structs
  of ``sharding.rules.tree_sharded_structs`` (an independent path);
- each repair of the sharded model at axis sizes that a head or token
  count does not divide, reduced to a fake 2×4 ("data", "model") mesh (the
  MoE case 1×4) on meta tensors (each failed before its repair): the q/k/v projections'
  head split, sequence attention (blockwise and full; the flash wrapper,
  which always ran on shards, beside them) with 4 or 6 query heads over 4
  devices and 2 KV heads, decode attention against a cache whose head dim
  is sharded, the MoE combine's (T·k) → (T, k) view, and the gradients of
  the attention output's and the MoE tokens' flattens in a train step;
- the dry run's collectives equal a real run's: one step of reduced
  Qwen3-1.7B (train, two microbatches) and of reduced Qwen3-MoE
  (``moe_impl="shard_map"``) on a 2×2 mesh, dry-run here under the fake
  group on meta tensors and run for real on four gloo processes: rank 0's
  collectives equal by category in count and bytes, the argument bytes
  equal the real state's local bytes, and so do the flash calls; each
  run's ``collectives_by_op`` sums to its category totals exactly, and
  the two runs name the same issuers with the same bytes;
- the repaired paths compute the unsharded values: on a real 1×4 gloo
  mesh, f32 forward logits (blockwise and full attention; 4 and 6 query
  heads over 2 KV heads), decode logits against a head-dim-sharded and a
  sequence-sharded cache, and a reduced Qwen3-MoE decode step, each within
  1e-5 of the single-device run;
- ``chip_smoke.dryrun_phase`` rehearses on the CPU at a reduced size (a
  world-1 gloo group for the real step, the dry run in its child process,
  one production cell through the CLI).
"""
import contextlib
import dataclasses
import json
import os
import socket
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402

from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import arch_names, get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import init_process_group, make_host_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.flash_ref import _fwd_impl  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.moe import moe_apply  # noqa: E402
from repro_torch.roofline.hlo import COLLECTIVES  # noqa: E402
from repro_torch.runtime.elastic import place  # noqa: E402
from repro_torch.sharding.act import activation_rules  # noqa: E402
from repro_torch.sharding.rules import DistConfig, Sharding, default_rules, resolve, tree_sharded_structs  # noqa: E402
from repro_torch.sharding.rules import axes as mesh_axes  # noqa: E402
from repro_torch.sharding.specs import batch_logical, named_param_logical  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402

TOL = 1e-5
SPAWN_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the flash wrapper's meta path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("kh", (4, 2, 1))
def test_flash_meta_path_shapes(dtype, kh):
    b, s, h, dh = 2, 64, 4, 32
    cpu = [torch.randn(b, s, n, dh, dtype=dtype) for n in (h, kh, kh)]
    meta = [t.to("meta") for t in cpu]
    calls = flash_ops.meta_kernel.calls
    want = flash_ops.flash_attention(*cpu)
    got = flash_ops.flash_attention(*meta)
    assert flash_ops.meta_kernel.calls == calls + 1
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    # under autograd: the kernel's saved lse is (B, S, KH, G) f32, as the CUDA branch saves it
    leaves = [t.clone().requires_grad_() for t in meta]
    out = flash_ops.flash_attention(*leaves)
    saved = out.grad_fn.saved_tensors
    _, lse_ref = _fwd_impl(*cpu, True, 64, 64)
    assert saved[-1].shape == lse_ref.shape == (b, s, kh, h // kh) and saved[-1].dtype == torch.float32
    assert flash_ops.meta_kernel.calls == calls + 2
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in meta]


class _OnXpu(torch.Tensor):
    """A meta tensor that reports a device with no flash path."""

    @property
    def device(self):
        return torch.device("xpu")


def test_flash_other_devices_still_raise():
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        flash_ops.flash_attention(torch.Tensor._make_subclass(_OnXpu, q), q, q)


# ---------------------------------------------------------------------------
# full-size cells
# ---------------------------------------------------------------------------
REFERENCE_CELLS = [("mamba2-370m", "decode_32k", False), ("qwen2-vl-2b", "decode_32k", True)]


@pytest.mark.parametrize("arch,shape,multi_pod", REFERENCE_CELLS)
def test_reference_cells_run(arch, shape, multi_pod):
    with D.fake_world(D.WORLDS[multi_pod]):
        rec = D.run_cell(arch, shape, multi_pod, verbose=False, device_type="cpu")
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["memory"]["alias_bytes"] > 0  # the cache, updated in place
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["count"] > 0


@pytest.mark.parametrize("arch", arch_names())
def test_train_argument_bytes_equal_the_sharded_structs(arch):
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    with D.fake_world(256):
        _, args, mesh, _, dist = D.build_cell(arch, "train_4k", False, device_type="cpu")
        state = init_train_state(cfg, device="meta")
        p_logical = named_param_logical(cfg)
        structs = tree_sharded_structs(
            {"params": dict(state["params"].named_parameters()), "opt": state["opt"], "step": state["step"],
             "batch": D._batch_structs(cfg, shape)},
            {"params": p_logical, "opt": {"m": p_logical, "v": p_logical, "count": ()}, "step": (),
             "batch": batch_logical(cfg, "train")},
            dist.rules, mesh)
        want = sum(s.local_nbytes for s in torch.utils._pytree.tree_leaves(
            structs, is_leaf=lambda x: hasattr(x, "local_nbytes")))
        assert D.local_bytes(args) == want


# ---------------------------------------------------------------------------
# the repairs, reduced, on fake 2×4 and 1×4 meshes of meta tensors
# ---------------------------------------------------------------------------
def gqa(heads=4):
    """Reduced Qwen3-1.7B: ``heads`` query heads over 2 KV heads, Dh 16."""
    return dataclasses.replace(reduced_config("qwen3-1.7b"), n_heads=heads)


@contextlib.contextmanager
def fake_mesh(cfg, shape, data=2):
    """A fake (data, 4) ("data", "model") mesh: 2 KV heads do not divide
    the model axis."""
    with D.fake_world(data * 4):
        mesh = make_host_mesh(4, "cpu")
        rules = default_rules(cfg, shape, mesh)
        with activation_rules(rules, mesh):
            yield mesh, rules


def placed(shape, logical, rules, mesh, dtype=torch.bfloat16):
    spec = resolve(shape, logical, rules, mesh_axes(mesh))
    return D.meta_place(torch.empty(shape, dtype=dtype, device="meta"), Sharding.of(mesh, spec))


def meta_layer(cfg, rules, mesh):
    return M.cast_params(D._params(cfg, rules, mesh, "meta", 0), torch.bfloat16)["layers"][0]


@pytest.mark.parametrize("heads", (4, 6))
@pytest.mark.parametrize("sequence", (True, False))
def test_repair_projection_head_split(heads, sequence):
    """DTensor shards the flat K projection's columns over "model" (its
    weight is whole there, 2 KV heads not dividing 4, and FSDP-sharded
    over "data"), and the (KH, Dh) view of 32 columns over 4 devices
    failed; 6 query heads likewise."""
    cfg = gqa(heads)
    s = 16 if sequence else 1
    with fake_mesh(cfg, ShapeConfig("t", s, 2, "train" if sequence else "decode")) as (mesh, rules):
        lp = meta_layer(cfg, rules, mesh)
        x = placed((2, s, cfg.d_model), ("batch", None, "act_embed"), rules, mesh)
        q, k, v = M._qkv(lp["mixer"], x, cfg, rms_norm, sequence=sequence)
    assert q.shape == (2, s, heads, 16) and k.shape == v.shape == (2, s, 2, 16)
    assert Shard(2) not in k.placements  # 2 KV heads stay whole over 4
    assert (Shard(2) in q.placements) == (heads % 4 == 0)


@pytest.mark.parametrize("impl", ("blockwise", "full", "kernel"))
@pytest.mark.parametrize("heads", (4, 6))
def test_repair_sequence_attention_on_shards(impl, heads):
    """The blockwise attention viewed its 4 query heads, sharded over 4,
    as (2 KV heads, 2): it now runs on each device's shards, as the flash
    wrapper always did."""
    cfg = gqa(heads)
    flags = M.RunFlags(attn_impl=impl)
    with fake_mesh(cfg, ShapeConfig("t", 16, 2, "train")) as (mesh, rules):
        lp = meta_layer(cfg, rules, mesh)
        x = placed((2, 16, cfg.d_model), ("batch", None, "act_embed"), rules, mesh)
        pos = torch.arange(16, device="meta")[None].expand(2, 16)
        y, _ = M._attn_seq(lp["mixer"], x, cfg, flags, pos, None, False)
    assert y.shape == (2, 16, cfg.d_model)


@pytest.mark.parametrize("heads", (4, 6))
def test_repair_decode_attention_on_shards(heads):
    """Decode viewed q's 4 heads, sharded over 4, as (2, 2) against a cache
    whose head dim is sharded (its 2 KV heads do not divide 4): it now
    attends on the cache's shards, the scores summed over the head dim's
    devices."""
    cfg = gqa(heads)
    shape = ShapeConfig("d", 32, 2, "decode")
    with fake_mesh(cfg, shape) as (mesh, rules):
        lp = meta_layer(cfg, rules, mesh)
        cache = D._cache(cfg, shape, DistConfig(rules=rules), mesh, "meta")[0]
        assert cache["k"].placements[1] == Shard(3)
        x = placed((2, 1, cfg.d_model), ("batch", None, "act_embed"), rules, mesh)
        y = M._attn_decode(lp["mixer"], x, cfg, cache, 31, None, rms_norm)
    assert y.shape == (2, 1, cfg.d_model)


@pytest.mark.parametrize("impl", ("blockwise", "full", "kernel"))
@pytest.mark.parametrize("heads", (4, 6))
def test_repair_train_step_backward(impl, heads):
    """A whole train step (remat full): the gradient of the attention
    output reached the (H, Dh) view behind the output projection with its
    flat dim sharded over 4 devices, which 6 heads do not divide; the
    attention shards' gradients came back with permuted strides."""
    cfg = gqa(heads)
    dist = DistConfig(rules={}, attn_impl=impl, q_block=8, kv_block=8, microbatches=1)
    with D.fake_world(8):
        rec = D.run_cell(cfg, ShapeConfig("t", 16, 4, "train"), False, dist, verbose=False,
                         mesh=make_host_mesh(4, "cpu"))
    assert rec["ok"], rec.get("traceback")
    assert rec["kernels"]["flash"] == (2 * cfg.n_layers if impl == "kernel" else 0)


@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "qwen3-moe-235b-a22b"))
def test_repair_moe_token_flatten_backward(arch):
    """A reduced MoE train step, two microbatches: the MoE's (B, S) → (B·S)
    token flatten got its gradient back over every device (the dispatch
    rows' layout), which 4 rows of B cannot be viewed from."""
    dist = DistConfig(rules={}, q_block=16, kv_block=16, microbatches=2)
    with D.fake_world(8):
        rec = D.run_cell(reduced_config(arch), ShapeConfig("t", 32, 8, "train"), False, dist, verbose=False,
                         mesh=make_host_mesh(4, "cpu"))
    assert rec["ok"], rec.get("traceback")


def test_repair_moe_combine_view():
    """The MoE combine viewed its (T·k) rows, sharded over all 4 devices
    of a 1×4 mesh, as (T = 2 tokens, k = 2)."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    with fake_mesh(cfg, ShapeConfig("d", 32, 2, "decode"), data=1) as (mesh, rules):
        lp = meta_layer(cfg, rules, mesh)
        x = placed((2, 1, cfg.d_model), ("batch", None, "act_embed"), rules, mesh)
        y, aux = moe_apply(lp["mlp"], x, cfg)
    assert y.shape == (2, 1, cfg.d_model) and aux.shape == ()


# ---------------------------------------------------------------------------
# dry run against real runs on four gloo processes
# ---------------------------------------------------------------------------
TRAIN = ShapeConfig("train", 16, 4, "train")
CELLS = {  # name: (arch, DistConfig fields, capacity factor)
    "qwen3-1.7b": ("qwen3-1.7b", dict(microbatches=2), None),
    "qwen3-moe-shard_map": ("qwen3-moe-235b-a22b", dict(microbatches=1, moe_impl="shard_map"), 8.0),
}


def cell(name):
    arch, fields, cf = CELLS[name]
    cfg = reduced_config(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return cfg, DistConfig(rules={}, **fields)


def summary(rec):
    return {"collectives": rec["collectives"], "collective_counts": rec["collective_counts"],
            "by_part": rec["collectives_by_part"], "by_op": rec["collectives_by_op"],
            "argument_bytes": rec["memory"]["argument_bytes"], "flash": rec["kernels"]["flash"]}


def rel_to_max(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def f32_params(cfg, rules, mesh):
    params = M.init_params(cfg, 0, torch.float32, "cpu")
    if mesh is None:
        return params
    from repro_torch.sharding.rules import tree_shardings

    sh = tree_shardings(dict(params.named_parameters()), named_param_logical(cfg), rules, mesh)
    return params.map(lambda n, p: place(p, sh[n]))


def values_1x4(mesh) -> dict:
    """max |Δ| / max |plain| of the repaired paths on ``mesh`` (1×4)."""
    from repro_torch.sharding.rules import tree_shardings
    from repro_torch.sharding.specs import cache_logical

    out = {}
    g = torch.Generator().manual_seed(1)
    for heads in (4, 6):
        cfg = dataclasses.replace(gqa(heads), n_layers=2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
        for impl in ("blockwise", "full"):
            flags = M.RunFlags(attn_impl=impl, q_block=8, kv_block=8)
            want = M.forward(f32_params(cfg, None, None), cfg, {"tokens": tokens}, flags, torch.float32)[0]
            rules = default_rules(cfg, ShapeConfig("t", 16, 2, "train"), mesh)
            params = f32_params(cfg, rules, mesh)
            with activation_rules(rules, mesh):
                got = M.forward(params, cfg, {"tokens": tokens}, flags, torch.float32)[0].full_tensor()
            out[f"forward.{impl}.h{heads}"] = rel_to_max(got, want)
        for split in ("head_dim", "seq"):
            shape = ShapeConfig("d", 32, 2, "decode")
            rules = default_rules(cfg, shape, mesh)
            if split == "seq":
                rules.update(cache_seq=("model",), kv_heads=None, head_dim=None)
            cache = M.init_cache(cfg, 2, 32, torch.float32, device="cpu")
            for c in cache:
                for t in c.values():
                    t.copy_(torch.randn(t.shape, generator=g))
            step = {"tokens": torch.randint(0, cfg.vocab_size, (2, 1), generator=g)}
            stacked = cache_logical(cfg)
            logical = [{k: v[1:] for k, v in stacked[0].items()} for _ in cache]
            sh = tree_shardings(cache, logical, rules, mesh)
            placed_cache = [{k: place(t.clone(), sh[i][k]) for k, t in c.items()} for i, c in enumerate(cache)]
            assert placed_cache[0]["k"].placements[1] == Shard(3 if split == "head_dim" else 1)
            want = M.decode_step(f32_params(cfg, None, None), cfg, cache, step, 20, compute_dtype=torch.float32)[0]
            params = f32_params(cfg, rules, mesh)
            with activation_rules(rules, mesh):
                got = M.decode_step(params, cfg, placed_cache, step, 20, compute_dtype=torch.float32)[0]
            out[f"decode.{split}.h{heads}"] = rel_to_max(got.full_tensor(), want)
            out[f"decode_cache.{split}.h{heads}"] = max(
                rel_to_max(pc[k].full_tensor(), c[k]) for pc, c in zip(placed_cache, cache) for k in c)
    cfg = reduced_config("qwen3-moe-235b-a22b")
    shape = ShapeConfig("d", 32, 2, "decode")
    rules = default_rules(cfg, shape, mesh)
    lp_plain = M.cast_params(f32_params(cfg, None, None), torch.float32)["layers"][0]["mlp"]
    lp = M.cast_params(f32_params(cfg, rules, mesh), torch.float32)["layers"][0]["mlp"]
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    want = moe_apply(lp_plain, x, cfg)[0]
    with activation_rules(rules, mesh):
        got = moe_apply(lp, x, cfg)[0].full_tensor()
    out["moe_decode"] = rel_to_max(got, want)
    return out


def _worker(rank, world, port, out_path):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    init_process_group("cpu")
    try:
        mesh = make_host_mesh(2, "cpu")
        report = {}
        for name in CELLS:
            cfg, dist = cell(name)
            fn, args, mesh, kind, dist = D.build_cell(cfg, TRAIN, False, dist, mesh=mesh, device="cpu")
            rec = D.run_step(fn, args, kind, mesh, dist.rules)
            report[name] = summary(rec)
        report["values_1x4"] = values_1x4(make_host_mesh(4, "cpu"))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_report():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        ctx = mp.start_processes(_worker, args=(4, free_port(), out), nprocs=4, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the gloo workers did not finish in {SPAWN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        with open(out) as f:
            return json.load(f)


@pytest.mark.parametrize("name", list(CELLS))
def test_dry_run_collectives_equal_a_real_run(gloo_report, name):
    cfg, dist = cell(name)
    with D.fake_world(4):
        mesh = make_host_mesh(2, "cpu")
        fn, args, mesh, kind, dist = D.build_cell(cfg, TRAIN, False, dist, mesh=mesh)
        dry = summary(D.run_step(fn, args, kind, mesh, dist.rules))
    real = gloo_report[name]
    assert dry["collective_counts"] == real["collective_counts"]
    assert dry["collectives"] == real["collectives"]
    assert dry["by_part"] == real["by_part"]
    assert dry["argument_bytes"] == real["argument_bytes"]
    assert dry["flash"] == real["flash"]
    assert real["collectives"]["count"] > 0
    if name == "qwen3-moe-shard_map":
        assert real["collective_counts"]["all-to-all"] >= 4  # dispatch and return, forward and backward


@pytest.mark.parametrize("name", list(CELLS))
def test_collectives_by_op_sum_to_the_category_totals(gloo_report, name):
    """``collectives_by_op`` files every collective under its issuer: over
    the issuers, each category's bytes and the op count sum to the step's
    totals exactly, in the dry run and in the real run alike, and both runs
    name the same issuers with the same bytes."""
    cfg, dist = cell(name)
    with D.fake_world(4):
        mesh = make_host_mesh(2, "cpu")
        fn, args, mesh, kind, dist = D.build_cell(cfg, TRAIN, False, dist, mesh=mesh)
        dry = summary(D.run_step(fn, args, kind, mesh, dist.rules))
    for rec in (dry, gloo_report[name]):
        rows = rec["by_op"].values()
        for cat in COLLECTIVES:
            assert sum(r[cat] for r in rows) == rec["collectives"][cat], cat
        assert sum(r["count"] for r in rows) == rec["collectives"]["count"]
        assert sum(r["bytes"] for r in rows) == rec["collectives"]["total"]
        assert all(" @ " in issuer and "?" not in issuer for issuer in rec["by_op"])
    assert dry["by_op"] == gloo_report[name]["by_op"]


def test_repaired_paths_compute_the_unsharded_values(gloo_report):
    errs = gloo_report["values_1x4"]
    assert len(errs) == 2 * (2 + 2 + 2) + 1, errs
    assert max(errs.values()) <= TOL, errs


def test_chip_smoke_dryrun_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.dryrun_phase`` with reduced Qwen3-1.7B on a (1, 1) gloo
    mesh (the flash kernel's plain version, so no launches): the dry run in
    its child process agrees with the real step in collectives, flash calls
    (two a layer: forward and recompute) and argument bytes, the one
    production cell given is ok, the two layout cells given (musicgen-large
    cut to one cycle; mistral-large-123b at one and two cycles) meet the
    reference's bars and the depth bars, and the process group is gone
    after."""
    import sys

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.dryrun_phase("cpu", device="cpu", cells=(("mamba2-370m", "decode_32k", False),),
                                  layout=("musicgen-large", "mistral-large-123b"), reduced=True, layers=2, seq=32,
                                  batch=4)
    assert out == {"flash": 0} and not dist.is_initialized()
    out_lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out_lines[-1])
    assert line["phase"] == "dryrun" and line["ok"]
    cross = line["crosscheck"]
    assert cross["flash"]["dry_run"] == cross["flash"]["want"] == 4
    assert cross["argument_bytes"]["card"] == cross["argument_bytes"]["dry_run"]
    assert cross["collectives"]["card"] == cross["collectives"]["dry_run"]
    assert [c["ok"] for c in line["cells"]] == [True]
    assert [(c["arch"], c["ok"]) for c in line["layout"]] == [("musicgen-large", True),
                                                              ("mistral-large-123b", True)]
    depth = [json.loads(ln)["layout_cell"] for ln in out_lines if '"layout_cell"' in ln][1]
    assert depth["arch"] == "mistral-large-123b" and {"temp_growth", "full_depth"} <= set(depth["bars"])
