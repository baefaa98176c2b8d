"""Sharded training of the port on a 2×2 ("data", "model") mesh of four
gloo processes, on the CPU, against the port's unsharded step:

- one f32 train step (attention and every RMSNorm through the kernel
  wrappers, so their plain versions run on each device's shards under the
  wrappers' placements) on reduced qwen3-1.7b, qwen3-moe (``moe_impl``
  dense and shard_map), grok-1 and jamba (``ssd_impl="reference"``, as
  Mamba-2 trains), the state placed by ``runtime.elastic.state_shardings``
  under ``default_rules`` and the step run under ``activation_rules``:
  the loss, the global gradient norm and every leaf's gradient (read from
  its first moment, max |Δ| / max |g|) within 1e-5 of the unsharded
  step's. One stated exception, ``tests/test_torch_train_moe.py``'s: the
  Mamba-2 ``a_log`` gradients (jamba) are held within 2e-4; that gradient
  sums terms of both signs over every position and cancels, so another
  summation order moves it by more (1.2e-5 here). The shard_map case runs dropless (capacity factor 8) with the
  aux weight at 0: its capacity and aux are per shard by design (the
  reference's), so only the dropless, aux-free step has a single-device
  twin; ``tests/test_torch_moe_shard_map.py`` holds its aux and drops
  against the reference's;
- a checkpoint written from the 2×2 state restores onto the mesh that
  ``shrink_mesh`` proposes for two survivors (1×2, ranks 0 and 1) equal to
  the saved state bit for bit, and ``reshard_state`` moves the live state
  there the same;
- the kernel wrappers (flash attention, RMSNorm, SSD) given DTensors
  sharded on the dims their kernels reduce or scan (the sequence, the
  head dim, the normalised axis, P and N) run their plain versions on
  shards in which those dims are whole (each call's shapes recorded), and
  equal the whole-tensor call; flash's query heads sharded over "model"
  with the KV heads whole take each device's KV heads, forward and
  gradients;
- ``python -m torch.distributed.run --nproc-per-node 4 -m
  repro_torch.launch.train --model-axis 2`` gives the world-1 launcher's
  loss trace within 1e-5 (both in f32);
- ``chip_smoke.train_mesh_phase`` rehearses on the CPU at a reduced size
  (a world-1 gloo group in this process, destroyed at its end).
"""
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.data.pipeline import for_model  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import init_process_group, make_host_mesh  # noqa: E402
from repro_torch.models.model import RunFlags  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.elastic import reshard_state, shrink_mesh, state_shardings  # noqa: E402
from repro_torch.sharding.act import activation_rules  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, A_LOG_TOL = 1e-5, 2e-4
SEQ, BATCH = 16, 4
KERNELS = dict(attn_impl="kernel", norm_impl="kernel")
CASES = {  # name: (arch, flags, capacity factor override, aux weight)
    "qwen3-1.7b": ("qwen3-1.7b", KERNELS, None, train_step.AUX_LOSS_WEIGHT),
    "qwen3-moe-dense": ("qwen3-moe-235b-a22b", KERNELS, None, train_step.AUX_LOSS_WEIGHT),
    "qwen3-moe-shard_map": ("qwen3-moe-235b-a22b", dict(KERNELS, moe_impl="shard_map"), 8.0, 0.0),
    "grok-1": ("grok-1-314b", KERNELS, None, train_step.AUX_LOSS_WEIGHT),
    "jamba": ("jamba-v0.1-52b", dict(KERNELS, ssd_impl="reference"), None, train_step.AUX_LOSS_WEIGHT),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, args, nprocs: int, timeout: float):
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes; fail after
    ``timeout`` seconds (the processes are killed)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def one_step(case, mesh=None):
    """(state, metrics, cfg, shape, rules) of one f32 step of ``case`` from
    seed 0, sharded over ``mesh`` or on plain tensors."""
    arch, flags, cf, aux_weight = CASES[case]
    cfg = reduced_config(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    batch = for_model(cfg, seq_len=SEQ, global_batch=BATCH, seed=0).next_batch()
    state = train_step.init_train_state(cfg, seed=0, device="cpu")
    step = train_step.make_train_step(cfg, RunFlags(**flags), opt, compute_dtype=torch.float32)
    train_step.AUX_LOSS_WEIGHT, weight = aux_weight, train_step.AUX_LOSS_WEIGHT
    try:
        if mesh is None:
            state, m = step(state, batch)
            return state, m, cfg, shape, None
        rules = default_rules(cfg, shape, mesh)
        state = reshard_state(state, state_shardings(cfg, shape, mesh, state, rules))
        with activation_rules(rules, mesh):
            state, m = step(state, batch)
        return state, m, cfg, shape, rules
    finally:
        train_step.AUX_LOSS_WEIGHT = weight


def rel_to_max(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


def _worker(rank, world, port, out_path, ckpt_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    init_process_group("cpu")
    try:
        mesh = make_host_mesh(2, "cpu")
        report = {}
        for case in CASES:
            state, m, cfg, shape, rules = one_step(case, mesh)
            plain, pm, *_ = one_step(case)
            leaves = {n: rel_to_max(state["opt"]["m"][n].full_tensor(), plain["opt"]["m"][n])
                      for n in plain["opt"]["m"]}
            report[case] = {"loss": [float(m["loss"]), float(pm["loss"])],
                            "grad_norm": [float(m["grad_norm"]), float(pm["grad_norm"])],
                            "aux": [float(m["aux_loss"]), float(pm["aux_loss"])],
                            "leaves": leaves}
            if case == "qwen3-moe-dense":  # the elastic checkpoint round trip
                report["elastic"] = elastic(state, cfg, shape, rules, ckpt_dir, rank)
        report["wrappers"] = wrapper_checks(mesh)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def elastic(state, cfg, shape, rules, ckpt_dir, rank):
    """Save the 2×2 state, restore it onto the shrunk mesh of ranks 0 and
    1; count the leaves that differ from the saved ones."""
    ckpt = CheckpointManager(ckpt_dir, keep_n=1, async_save=True)
    ckpt.save(1, state)
    ckpt.wait()
    saved = {k: v.full_tensor() for k, v in _leaves(state)}
    (data, model), names = shrink_mesh(2, model_axis=2)
    small = DeviceMesh("cpu", torch.arange(data * model).reshape(data, model), mesh_dim_names=names)
    shardings = state_shardings(cfg, shape, small, state, default_rules(cfg, shape, small))
    restored, meta = ckpt.restore(state, shardings=shardings)
    moved = reshard_state(state, shardings)
    out = {"mesh": [data, model], "step": meta["step"]}
    if rank < data * model:
        out["restored_differ"] = sum(not torch.equal(v.full_tensor(), saved[k]) for k, v in _leaves(restored))
        out["resharded_differ"] = sum(not torch.equal(v.full_tensor(), saved[k]) for k, v in _leaves(moved))
        out["leaves"] = len(saved)
        out["on_small_mesh"] = all(v.device_mesh == small for _, v in _leaves(restored))
    return out


def wrapper_checks(mesh):
    """Each kernel wrapper on DTensors sharded where its kernel must see
    whole dims: {case: {"err": max |sharded - whole|, "seen": the dims the
    plain version got, "whole": those dims' full sizes}}."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.rmsnorm import ops as N
    from repro_torch.kernels.ssd import ops as S

    seen = []

    def spy(fn, dims):
        def wrapped(*a, **k):
            seen.append([a[0].shape[d] for d in dims])
            return fn(*a, **k)
        return wrapped

    g = torch.Generator().manual_seed(5)
    put = lambda t, pl: distribute_tensor(t, mesh, pl)  # noqa: E731
    whole = [Replicate(), Replicate()]
    out = {}

    def record(name, err, full):
        out[name] = {"err": err, "seen": seen[:], "whole": full}
        seen.clear()

    # RMSNorm: the normalised (last) axis sharded over "model"
    x, w = torch.randn(4, 8, 32, generator=g), torch.randn(32, generator=g)
    N.rmsnorm_reference, keep = spy(N.rmsnorm_reference, [-1]), N.rmsnorm_reference
    try:
        got = N.rmsnorm(put(x, [Shard(0), Shard(2)]), put(w, [Shard(0), Replicate()]), 1e-6)
    finally:
        N.rmsnorm_reference = keep
    record("rmsnorm", (got.full_tensor() - N.rmsnorm(x, w, 1e-6)).abs().max().item(), [32])

    # flash: the sequence over "data" and the head dim over "model"
    q, k, v = (torch.randn(4, 16, n, 16, generator=g) for n in (8, 2, 2))
    F.attention_reference, keep = spy(F.attention_reference, [2, 3]), F.attention_reference
    try:
        got = F.flash_attention(*(put(t, [Shard(1), Shard(3)]) for t in (q, k, v)))
    finally:
        F.attention_reference = keep
    record("flash_seq_and_head_dim", (got.full_tensor() - F.flash_attention(q, k, v)).abs().max().item(),
           [16, 16])

    # flash under autograd: query heads over "model" (4 a device), the two KV
    # heads whole: each device reads its own KV head; gradients included
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = F.flash_attention(*leaves)
    want_g = torch.autograd.grad(want.square().sum(), leaves)
    dq, dk, dv = (put(t, pl).requires_grad_() for t, pl in
                  ((q, [Shard(0), Shard(2)]), (k, [Shard(0), Replicate()]), (v, [Shard(0), Replicate()])))
    F._fwd_impl, keep = spy(F._fwd_impl, [1, 3]), F._fwd_impl
    try:
        got = F.flash_attention(dq, dk, dv)
        got_g = torch.autograd.grad(got.square().sum(), [dq, dk, dv])
    finally:
        F._fwd_impl = keep
    err = max([(got.full_tensor() - want).abs().max().item()]
              + [(a.full_tensor() - b).abs().max().item() for a, b in zip(got_g, want_g)])
    record("flash_heads_kv_whole_grad", err, [16, 16])

    # SSD: the sequence over "data", P over "model"; B and C with N sharded
    b, s_, h, p, n = 2, 32, 4, 8, 8
    x = torch.randn(b, s_, h, p, generator=g)
    dt, a = torch.rand(b, s_, h, generator=g) * 0.1, -torch.rand(h, generator=g)
    bm, cm = (torch.randn(b, s_, n, generator=g) for _ in range(2))
    y, hf = S.ssd(x, dt, a, bm, cm, chunk=8)
    S.ssd_reference, keep = spy(S.ssd_reference, [1, 3]), S.ssd_reference
    try:
        gy, gh = S.ssd(put(x, [Shard(1), Shard(3)]), put(dt, whole), put(a, whole),
                       put(bm, [Replicate(), Shard(2)]), put(cm, [Shard(1), Shard(2)]), chunk=8)
    finally:
        S.ssd_reference = keep
    record("ssd", max((gy.full_tensor() - y).abs().max().item(), (gh.full_tensor() - hf).abs().max().item()),
           [32, 8])
    return out


def _leaves(state):
    yield from (("p." + n, p) for n, p in state["params"].named_parameters())
    for key in ("m", "v"):
        yield from ((f"{key}.{n}", t) for n, t in state["opt"][key].items())
    yield "count", state["opt"]["count"]
    yield "step", state["step"]


@pytest.fixture(scope="module")
def report():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        spawn(_worker, (4, free_port(), out, os.path.join(tmp, "ckpt")), 4, timeout=600)
        with open(out) as f:
            return json.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded(report, case):
    r = report[case]
    for key in ("loss", "grad_norm"):
        got, want = r[key]
        assert abs(got - want) <= TOL * abs(want), (key, got, want)
    for leaf, err in r["leaves"].items():
        assert err <= (A_LOG_TOL if leaf.endswith("mixer.a_log") else TOL), (leaf, err)
    if case != "qwen3-moe-shard_map":
        assert abs(r["aux"][0] - r["aux"][1]) <= TOL


def test_checkpoint_restores_onto_the_shrunk_mesh_bit_for_bit(report):
    e = report["elastic"]
    assert e["mesh"] == [1, 2] and e["step"] == 1 and e["on_small_mesh"]
    assert e["leaves"] > 10
    assert e["restored_differ"] == 0 and e["resharded_differ"] == 0


@pytest.mark.parametrize("case", ["rmsnorm", "flash_seq_and_head_dim", "flash_heads_kv_whole_grad", "ssd"])
def test_kernel_wrappers_see_whole_reduced_dims(report, case):
    r = report["wrappers"][case]
    assert r["seen"] and all(d == r["whole"] for d in r["seen"]), r
    assert r["err"] <= 1e-6, r


def test_launcher_on_a_2x2_mesh_gives_the_world_1_trace(tmp_path):
    args = ["--device", "cpu", "--reduced", "--steps", "3", "--seq-len", str(SEQ), "--global-batch",
            str(BATCH), "--compute-dtype", "float32", "--save-every", "2"]
    one = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.train", *args, "--model-axis", "2",
         "--ckpt-dir", str(tmp_path / "four")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert "on a (2, 2) mesh of cpu" in run.stdout
    four = json.loads(re.search(r"^losses (.*)$", run.stdout, re.M).group(1))
    assert len(four) == len(one) == 3
    for a, b in zip(four, one):
        assert abs(a - b) <= TOL * abs(b), (four, one)
    assert sorted(os.listdir(tmp_path / "four")) == ["step_00000002"]


def test_chip_smoke_train_mesh_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.train_mesh_phase`` on a (1, 1) gloo mesh with reduced
    configs (the kernels' plain versions, no launches to count, no sync
    check): the mesh step equals the unsharded step bit for bit at world 1,
    the checkpoint round trip holds, the shard_map MoE layer equals the
    dense one with 2 + 2 exchanges, and the process group is gone after."""
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    beside = {"step_wall_s": 1.0, "tokens_per_s": 128.0, "max_memory_allocated": None}
    launches = chip_smoke.train_mesh_phase("cpu", cfg, reduced_config("qwen3-moe-235b-a22b"), device="cpu",
                                           beside=beside, seq=32, batch=4, steps=2, moe_batch=2, moe_seq=16)
    assert launches["flash"] == launches["rmsnorm"] == 0 and not dist.is_initialized()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "train_mesh" and line["ok"] and line["state_placed"]
    assert line["loss_bitwise"] and line["unsharded_bitwise_equal_leaves"] == line["leaves"]
    assert line["checkpoint"]["differ"] == [] and line["checkpoint"]["same_placements"]
    assert line["moe"]["exchanges"] == {"forward": 2, "backward": 2} and line["moe"]["y_err"] == 0.0
    assert line["train_same_call"] == beside
