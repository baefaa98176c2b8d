"""The device chain block on the card: threefry on CUDA against the CPU, the
block's invariants bit for bit, K kernel launches a block, no host
synchronisation inside the K iterations, and the same sequences on the card
as on the CPU path. Every test here needs a CUDA device: each carries the
``gpu`` marker and skips where there is none.

This file imports only the port and ``chip_smoke.py``'s helpers (no JAX, no
JAX package), so it runs on a machine that has PyTorch with CUDA and
nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_chain.py
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import same_block, sync_errors  # noqa: E402

REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain block's kernel has no CPU mode")
    return torch.device("cuda")


def _fixture(graph="ar_complex", seed=1):
    db = P.HardwareDatabase()
    g = getattr(P, graph)()
    return g, db, P.calibrated_budget(db), P.random_single_noc_designs(g, 1, seed=seed)[0]


@pytest.mark.gpu
def test_threefry_on_card_matches_cpu(cuda):
    keys = prng.fold_in(prng.prng_key(7), torch.arange(512))
    kc = keys.to(cuda)
    assert torch.equal(prng.split(kc, 3).cpu(), prng.split(keys, 3))
    assert torch.equal(prng.uniform(kc).cpu(), prng.uniform(keys))
    assert torch.equal(prng.random_bits(kc, (1000,)).cpu(), prng.random_bits(keys, (1000,)))
    logits = torch.randn(512, 1000, generator=torch.Generator().manual_seed(0))
    logits[:, ::3] = -1e30
    assert torch.equal(prng.categorical(kc, logits.to(cuda)).cpu(), prng.categorical(keys, logits))


@pytest.mark.gpu
@pytest.mark.parametrize("menu,alloc", [("naive_sa", False), ("telemetry", True), ("farsi", True)])
def test_block_launches_kernel_k_times_without_host_sync(cuda, menu, alloc):
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    g, db, bud, d = _fixture()
    runner = P.DeviceChainRunner(g, db)
    assert runner.device.type == "cuda"
    runner.loop_guard = sync_errors()
    runner.run_chains(d, bud, r=16, k=8, seed=2, menu=menu, alloc=alloc)
    before = phase_sim_cuda.launches
    res = runner.run_chains(d, bud, r=16, k=32, seed=2, menu=menu, alloc=alloc)
    assert phase_sim_cuda.launches - before == 32
    assert res.move_idx.shape == (16, 32) and np.all(np.isfinite(res.fit_trace[:, -1]))


@pytest.mark.gpu
@pytest.mark.parametrize("alloc", [False, True])
def test_fused_block_equals_host_loop_on_card(cuda, alloc):
    g, db, bud, d = _fixture()
    runner = P.DeviceChainRunner(g, db)
    fused = runner.run_chains(d, bud, r=1, k=24, seed=5, menu="farsi", alloc=alloc)
    host = runner.run_chains_host(d, bud, r=1, n_steps=24, seed=5, menu="farsi", alloc=alloc)
    assert same_block(fused, host)


@pytest.mark.gpu
def test_chain_independent_of_population_on_card(cuda):
    g, db, bud, d = _fixture()
    runner = P.DeviceChainRunner(g, db)
    small = runner.run_chains(d, bud, r=16, k=16, seed=3, menu="farsi", alloc=True)
    big = runner.run_chains(d, bud, r=256, k=16, seed=3, menu="farsi", alloc=True)
    assert same_block(small, big, (0, 5, 15))


@pytest.mark.gpu
def test_checkpoint_resume_on_card(cuda):
    g, db, bud, d = _fixture()
    runner = P.DeviceChainRunner(g, db)
    whole = runner.run_chains(d, bud, r=4, k=16, seed=9, menu="farsi", alloc=True)
    first = runner.run_chains(d, bud, r=4, k=8, seed=9, menu="farsi", alloc=True)
    pol = P.make_policy("device_sa")
    pol.device_carry = first.carry
    ck = pol.checkpoint()
    pol.restore(ck)
    rest = runner.run_chains(d, bud, r=4, k=8, seed=9, it0=8, menu="farsi", alloc=True,
                             carry=pol.device_carry)
    for i in range(4):
        assert whole.seq(i) == first.seq(i) + rest.seq(i)
    assert all(np.array_equal(x, y) for x, y in zip(whole.carry, rest.carry))


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["audio", "ar_complex"])
def test_card_samples_the_cpu_sequences(cuda, graph):
    g, db, bud, d = _fixture(graph)
    kw = dict(r=4, k=16, seed=4, menu="farsi", alloc=True)
    on_card = P.DeviceChainRunner(g, db).run_chains(d, bud, **kw)
    on_cpu = P.DeviceChainRunner(g, db, device="cpu").run_chains(d, bud, **kw)
    for i in range(4):
        assert on_card.seq(i) == on_cpu.seq(i), i
    rel = np.abs(on_card.fit_trace.astype(np.float64) - on_cpu.fit_trace) / np.abs(on_cpu.fit_trace)
    assert rel.max() <= REL_TOL
    for name, a, b in zip(on_cpu.carry._fields, on_cpu.carry, on_card.carry):
        if np.issubdtype(a.dtype, np.floating):
            err = np.abs(b.astype(np.float64) - a) / np.maximum(np.abs(a), 1e-12)
            assert err.max() <= REL_TOL, name
        else:
            assert np.array_equal(a, b), name


@pytest.mark.gpu
def test_reconcile_alloc_reprices_winner_on_card(cuda):
    g, db, bud, d = _fixture()
    runner = P.DeviceChainRunner(g, db)
    res = runner.run_chains(d, bud, r=16, k=32, seed=9, menu="farsi", alloc=True)
    d2 = copy.deepcopy(d)
    runner.reconcile_alloc(d2, res)
    host_fit = P.distance(P.simulate(d2, g, db), bud).fitness(0.05)
    dev_fit = float(res.fitness[res.winner])
    assert abs(host_fit - dev_fit) <= REL_TOL * abs(dev_fit)


@pytest.mark.gpu
def test_explorer_run_chains_on_card(cuda):
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    g, db, bud, _ = _fixture()
    ex = P.Explorer(g, db, bud, P.ExplorerConfig(
        policy="farsi", chain_r=16, chain_k=32, chain_alloc=True, max_iterations=64, seed=1))
    before = phase_sim_cuda.launches
    res = ex.run_chains()
    assert phase_sim_cuda.launches - before == 64 + 1
    assert ex.backend.stats().n_dispatches == 2 + 1
    fit = P.distance(P.simulate(res.best_design, g, db), bud).fitness(0.05)
    last = res.history[-1]["fitness"]
    assert abs(fit - last) <= REL_TOL * abs(fit)
