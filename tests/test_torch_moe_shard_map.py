"""The port's expert-parallel MoE (``models.moe_shard_map``) against the
reference's ``moe_apply_shard_map`` and against the port's dense
``moe_apply``, on the CPU:

- 1×1 (a world of one gloo process, in this process): y, aux and every
  gradient equal the reference's ``moe_apply_shard_map`` on a 1×1 mesh,
  and, dropless, the dense ``moe_apply``'s (at axis sizes of 1 the
  reference says the two agree), within 1e-5 in f32;
- 2×2 (four gloo processes): y, aux and the gradients of
  ``Σ tanh(y) + aux`` with respect to every parameter and to x, against
  the reference on a 2×2 mesh of four host devices with Auto axes (a
  subprocess with ``--xla_force_host_platform_device_count=4``: under JAX
  0.9 the reference's own test builds Explicit axes and fails; on Auto
  axes the reference runs whole), within 1e-5 in f32 — dropless (capacity
  factor 8) and with drops (factor 1, where the per-shard capacity decides
  which assignments drop), each with the batch over "data" only (the
  model shards dispatch the same tokens) and with the sequence over
  "model" as well (the default rules' ``seq_res``).

Bars: max |port - reference| ≤ 1e-5 · max(1, max |reference|).
"""
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.models.moe_shard_map import moe_apply_shard_map as ref_shard_map  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.launch.mesh import init_process_group, make_host_mesh  # noqa: E402
from repro_torch.models.moe import capacity, moe_apply, positions, route  # noqa: E402
from repro_torch.models.moe_shard_map import moe_apply_shard_map  # noqa: E402
from repro_torch.sharding.act import activation_rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-235b-a22b"
CASES = {  # name: (capacity factor, seq_res rule)
    "cf8_batch": (8.0, None), "cf8_seq": (8.0, ("model",)),
    "cf1_batch": (1.0, None), "cf1_seq": (1.0, ("model",)),
}
LEAVES = ("router", "wi_gate", "wi_up", "wo")
TOL = 1e-5


def close(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def inputs():
    cfg = reduced_config(ARCH)
    rng = np.random.default_rng(0)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {"x": rng.standard_normal((2, 16, d)).astype(np.float32),
            "router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
            "wi_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            "wi_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            "wo": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}


def rules_of(seq_res):
    return {"batch": ("data",), "seq_res": seq_res}


# ---------------------------------------------------------------------------
# 1×1, in process
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def port_run(p_np, x_np, cfg, mesh, rules, placements_x):
    """(y, aux, {leaf: grad, "x": grad}) of the port's shard_map MoE, whole."""
    p = {k: distribute_tensor(torch.from_numpy(p_np[k]), mesh, [Replicate()] * mesh.ndim).requires_grad_()
         for k in LEAVES}
    x = distribute_tensor(torch.from_numpy(x_np), mesh, placements_x).requires_grad_()
    with activation_rules(rules, mesh):
        y, aux = moe_apply_shard_map(p, x, cfg, mesh, rules)
        loss = torch.tanh(y).sum() + aux
        loss.redistribute(mesh, [Replicate()] * mesh.ndim).backward()
    grads = {k: p[k].grad.full_tensor().numpy() for k in LEAVES}
    grads["x"] = x.grad.full_tensor().numpy()
    return y.full_tensor().detach().numpy(), aux.full_tensor().item(), grads


def dense_run(p_np, x_np, cfg):
    p = {k: torch.from_numpy(p_np[k]).requires_grad_() for k in LEAVES}
    x = torch.from_numpy(x_np).requires_grad_()
    y, aux = moe_apply(p, x, cfg)
    (torch.tanh(y).sum() + aux).backward()
    return y.detach().numpy(), aux.item(), {**{k: p[k].grad.numpy() for k in LEAVES}, "x": x.grad.numpy()}


def reference_1x1(p_np, x_np, cfg_ref, rules):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    p = {k: jnp.asarray(p_np[k]) for k in LEAVES}
    f = lambda p_, x_: ref_shard_map(p_, x_, cfg_ref, mesh, rules)  # noqa: E731
    with mesh:
        y, aux = jax.jit(f)(p, jnp.asarray(x_np))
        gp, gx = jax.jit(jax.grad(lambda p_, x_: jnp.sum(jnp.tanh(f(p_, x_)[0])) + f(p_, x_)[1],
                                  argnums=(0, 1)))(p, jnp.asarray(x_np))
    return np.asarray(y), float(aux), {**{k: np.asarray(gp[k]) for k in LEAVES}, "x": np.asarray(gx)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_1x1_equals_dense_and_reference(inputs, case):
    cf, seq_res = CASES[case]
    cfg = dataclasses.replace(reduced_config(ARCH), capacity_factor=cf)
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), capacity_factor=cf)
    rules = rules_of(seq_res)
    with world_of_one() as mesh:
        y, aux, g = port_run(inputs, inputs["x"], cfg, mesh, rules, [Shard(0), Replicate()])
    yd, auxd, gd = dense_run(inputs, inputs["x"], cfg)
    yr, auxr, gr = reference_1x1(inputs, inputs["x"], cfg_ref, rules)
    if cf == 8.0:
        # dropless, the two agree (with drops the shard_map aux counts kept
        # assignments only, the dense one every assignment, in both packages)
        assert close(y, yd) <= TOL and abs(aux - auxd) <= TOL
        for k in gd:
            assert close(g[k], gd[k]) <= TOL, (k, close(g[k], gd[k]))
    assert close(y, yr) <= TOL and abs(aux - auxr) <= TOL
    for k in gr:
        assert close(g[k], gr[k]) <= TOL, (k, close(g[k], gr[k]))
    for k in g:
        assert np.isfinite(g[k]).all()


# ---------------------------------------------------------------------------
# 2×2: four gloo processes against the reference on four host devices
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.registry import reduced_config
from repro.models.moe_shard_map import moe_apply_shard_map
CASES = %r
inp = np.load(sys.argv[1])
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for case, (cf, seq_res) in CASES.items():
    cfg = dataclasses.replace(reduced_config(%r), capacity_factor=cf)
    rules = {"batch": ("data",), "seq_res": seq_res}
    p = {k: jnp.asarray(inp[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
    x = jax.device_put(jnp.asarray(inp["x"]), NamedSharding(mesh, P("data", None, None)))
    f = lambda p_, x_: moe_apply_shard_map(p_, x_, cfg, mesh, rules)
    with mesh:
        y, aux = jax.jit(f)(p, x)
        gp, gx = jax.jit(jax.grad(lambda p_, x_: jnp.sum(jnp.tanh(f(p_, x_)[0])) + f(p_, x_)[1],
                                  argnums=(0, 1)))(p, x)
    out[case + ".y"], out[case + ".aux"], out[case + ".x"] = np.asarray(y), np.asarray(aux), np.asarray(gx)
    for k, v in gp.items():
        out[case + "." + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _port_worker(rank, world, port, in_path, out_path):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    init_process_group("cpu")
    try:
        mesh = make_host_mesh(2, "cpu")
        inp = dict(np.load(in_path))
        out = {}
        for case, (cf, seq_res) in CASES.items():
            cfg = dataclasses.replace(reduced_config(ARCH), capacity_factor=cf)
            y, aux, g = port_run(inp, inp["x"], cfg, mesh, rules_of(seq_res), [Shard(0), Replicate()])
            out[case + ".y"], out[case + ".aux"] = y, np.asarray(aux)
            for k, v in g.items():
                out[case + "." + k] = v
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


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


@pytest.fixture(scope="module")
def runs_2x2(inputs):
    """(port, reference) arrays of every 2×2 case: the reference's
    subprocess (one XLA thread) and then the port's four processes, one
    after the other to keep the test's load on the machine's cores low."""
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.npz")
        np.savez(in_path, **inputs)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false "
                             "intra_op_parallelism_threads=1")
        ref = subprocess.run([sys.executable, "-c", REF_SCRIPT % (CASES, ARCH), in_path,
                              os.path.join(tmp, "ref.npz")], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert ref.returncode == 0, ref.stdout[-4000:] + ref.stderr[-4000:]
        spawn(_port_worker, (4, free_port(), in_path, os.path.join(tmp, "port.npz")), 4, timeout=300)
        return dict(np.load(os.path.join(tmp, "port.npz"))), dict(np.load(os.path.join(tmp, "ref.npz")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_2x2_forward_equals_reference(runs_2x2, case):
    port, ref = runs_2x2
    assert close(port[case + ".y"], ref[case + ".y"]) <= TOL
    assert abs(float(port[case + ".aux"]) - float(ref[case + ".aux"])) <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_2x2_gradients_equal_reference(runs_2x2, case):
    port, ref = runs_2x2
    for k in LEAVES + ("x",):
        g = port[f"{case}.{k}"]
        assert np.isfinite(g).all(), k
        assert close(g, ref[f"{case}.{k}"]) <= TOL, (k, close(g, ref[f"{case}.{k}"]))


@pytest.mark.parametrize("case", ["cf1_batch", "cf1_seq"])
def test_small_capacity_drops_assignments_per_shard(inputs, case):
    """At factor 1 the per-shard capacity drops assignments, and others
    than the global capacity would: the 2×2 cases with drops hold the
    per-shard rule, not the dense one."""
    cf, seq_res = CASES[case]
    cfg = dataclasses.replace(reduced_config(ARCH), capacity_factor=cf)
    x, router = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["router"])
    blocks = [x[i:i + 1] for i in range(2)]  # the batch over "data", in token order
    if seq_res:
        blocks = [b[:, j * 8:(j + 1) * 8] for b in blocks for j in range(2)]
    t_loc = blocks[0].shape[0] * blocks[0].shape[1]
    c_loc = max(cfg.top_k, int(np.ceil(t_loc * cfg.top_k * cf / cfg.n_experts)))

    def kept(tokens, c):
        _, _, idx = route(tokens.reshape(-1, cfg.d_model), router, cfg.top_k)
        return positions(idx.reshape(-1), cfg.n_experts) < c

    per_shard = torch.cat([kept(b, c_loc) for b in blocks])
    whole = kept(x, capacity(32, cfg))
    assert not per_shard.all() and not torch.equal(per_shard, whole)
