"""The mesh path on the card, on a (1, 1) ("data", "model") mesh of one
process over NCCL: the kernel wrappers given DTensors launch their kernels
on the local shards (the same launches as on plain tensors, the same
outputs bit for bit), a reduced Qwen3 and Qwen3-MoE train step on the mesh
against the unsharded step at the gpu train bars, and
``moe_apply_shard_map`` forward and backward free of host syncs with two
expert exchanges each way. Every test here needs a CUDA device: each
carries the ``gpu`` marker and skips where there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_mesh.py

The module's fixture starts the process group and destroys it at the end:
a process holds one default group.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke

from chip_smoke import (TRAIN_GRAD_RTOL, MOE_SM_TOL, host_snapshot, mesh_moe_check,  # noqa: E402
                        step_vs_plain)


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group("cuda")
    try:
        yield make_host_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def placed(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements)


@pytest.mark.gpu
def test_flash_on_dtensors_launches_the_kernel(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 512, n, 128, generator=g, device="cuda").to(torch.bfloat16) for n in (16, 8, 8))
    FK.reset_launches()
    want = flash_attention(q, k, v)
    plain = dict(FK.launches_by_route)
    FK.reset_launches()
    got = flash_attention(*(placed(t, mesh, [Shard(0), Shard(2)]) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert isinstance(got, DTensor) and FK.launches_by_route == plain == {"tensor_cores": 1, "cuda_cores": 0}
    assert got.placements == (Shard(0), Shard(2))
    assert torch.equal(got.full_tensor(), want)
    FK.reset_launches()
    rep = [Replicate(), Replicate()]
    got = flash_attention(*(placed(t, mesh, rep) for t in (q, k, v)))
    assert FK.flash_attention_cuda.launches == 1 and torch.equal(got.full_tensor(), want)


@pytest.mark.gpu
def test_rmsnorm_on_dtensors_launches_the_kernel(mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 512, 2048, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(2048, generator=g, device="cuda").to(torch.bfloat16)
    rmsnorm_cuda.launches = 0
    want = rmsnorm(x, w, 1e-6)
    assert rmsnorm_cuda.launches == 1
    for pl in ([Shard(0), Shard(1)], [Replicate(), Shard(2)]):  # the normalised axis is made whole
        rmsnorm_cuda.launches = 0
        got = rmsnorm(placed(x, mesh, pl), placed(w, mesh, [Replicate(), Replicate()]), 1e-6)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.launches == 1 and torch.equal(got.full_tensor(), want), pl
        assert all(p.dim != 2 for p in got.placements if isinstance(p, Shard))


@pytest.mark.gpu
def test_ssd_on_dtensors_launches_the_kernel(mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ops import ssd

    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, p, n = 2, 256, 8, 64, 64
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(torch.bfloat16)
    dt = torch.rand(b, s, h, generator=g, device="cuda") * 0.1
    a = -torch.rand(h, generator=g, device="cuda")
    bm, cm = (torch.randn(b, s, n, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    SK.ssd_cuda.launches = 0
    y, hf = ssd(x, dt, a, bm, cm, chunk=64)
    rep = [Replicate(), Replicate()]
    SK.ssd_cuda.launches = 0
    got_y, got_h = ssd(placed(x, mesh, [Shard(0), Shard(2)]), placed(dt, mesh, rep), placed(a, mesh, rep),
                       placed(bm, mesh, rep), placed(cm, mesh, rep), chunk=64)
    torch.cuda.synchronize()
    assert SK.ssd_cuda.launches == 1
    assert torch.equal(got_y.full_tensor(), y) and torch.equal(got_h.full_tensor(), hf)


def mesh_step(cfg, mesh, batch, opt, flags):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime.elastic import reshard_state, state_shardings
    from repro_torch.sharding.act import activation_rules
    from repro_torch.sharding.rules import default_rules
    from repro_torch.train.step import init_train_state, make_train_step

    shape = ShapeConfig("train", batch["labels"].shape[1], batch["labels"].shape[0], "train")
    rules = default_rules(cfg, shape, mesh)
    state = init_train_state(cfg, seed=0)
    state = reshard_state(state, state_shardings(cfg, shape, mesh, state, rules))
    with activation_rules(rules, mesh):
        return make_train_step(cfg, flags, opt)(state, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("name,layers", [("qwen3-1.7b", 3), ("qwen3-moe-235b-a22b", 2)])
def test_reduced_mesh_step_matches_unsharded_step(mesh, name, layers):
    """One kernel step on the (1, 1) mesh against the same step on plain
    tensors: the gpu train bars (loss 2e-2, grad norm 5e-2, each leaf's
    gradient within ``TRAIN_GRAD_RTOL``) and the same kernel launches."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.models.model import RunFlags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(reduced_config(name), n_layers=layers)
    batch = for_model(cfg, seq_len=128, global_batch=4, seed=0).next_batch()
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    flags = RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full")
    FK.reset_launches()
    rmsnorm_cuda.launches = 0
    ms, mm = mesh_step(cfg, mesh, batch, opt, flags)
    torch.cuda.synchronize()
    assert FK.flash_attention_cuda.launches == cfg.n_layers * 2
    assert rmsnorm_cuda.launches == cfg.n_layers * 4 * 2 + 1
    snap = host_snapshot(ms)
    ps, pm = make_train_step(cfg, flags, opt)(init_train_state(cfg, seed=0), batch)
    vs, ok = step_vs_plain(snap, {k: float(v) for k, v in mm.items()}, ps, pm)
    assert ok and vs["grad_rel_norm_worst"]["value"] <= TRAIN_GRAD_RTOL, vs


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_shard_map_moe_is_sync_free_and_matches_dense(mesh, name):
    """``chip_smoke.mesh_moe_check`` at a reduced config: forward and
    backward under sync-debug "error", two exchanges each way, y, aux and
    every gradient within 1e-5 of ``moe_apply``'s (dropless, f32)."""
    from repro_torch.configs.registry import reduced_config

    cfg = dataclasses.replace(reduced_config(name), capacity_factor=8.0)
    out = mesh_moe_check(cfg, mesh, 2, 64, "cuda", on_card=True)
    assert "error" not in out, out
    assert out["exchanges"] == {"forward": 2, "backward": 2}
    assert out["grads_finite"] and out["y_err"] <= MOE_SM_TOL and out["aux_err"] <= MOE_SM_TOL
    assert max(out["grad_rel_to_max"].values()) <= MOE_SM_TOL, out["grad_rel_to_max"]
