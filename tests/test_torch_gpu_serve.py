"""The serve layer on the card: a ``DseService`` whose every shared
dispatch launches the CUDA phase-sim kernel walks the same moves as the
same service on the CPU, with no fault, degradation or fallback, and a store
hit on the card is bit-identical to the dispatch it memoized. Every test here
needs a CUDA device: each carries the ``gpu`` marker and skips where there
is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_serve.py
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
import repro_torch.serve as PS  # noqa: E402
from repro_torch.core.backend import Candidate  # noqa: E402

REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase-sim kernel has no CPU mode")
    return torch.device("cuda")


def seq(res):
    return [(h["iteration"], h["move"], bool(h["accepted"])) for h in res.history]


def serve(device):
    db = P.HardwareDatabase()
    bud = P.calibrated_budget(db)
    g = P.ar_complex()
    svc = PS.DseService(db, device=device)
    for i, pol in enumerate(("farsi", "naive_sa", "bottleneck", "locality")):
        svc.submit(f"s{i}", g, bud, P.ExplorerConfig(policy=pol, seed=i % 2, max_iterations=30))
    svc.submit("chain", g, bud, P.ExplorerConfig(policy="farsi", seed=3, max_iterations=32,
                                                 chain_r=4, chain_k=16, chain_alloc=True))
    return svc, svc.run()


@pytest.mark.gpu
def test_service_on_card_matches_cpu(cuda):
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    phase_sim_cuda.launches = 0
    card, st = serve(None)
    launches = phase_sim_cuda.launches
    cpu, want = serve("cpu")
    (backend,) = card.scheduler.backends().values()
    assert backend.device.type == "cuda"
    assert st.n_done == want.n_done == 5
    for k in ("n_failed", "n_degraded", "n_fallback", "n_dispatch_faults", "n_nonfinite_rejected"):
        assert getattr(st, k) == 0, k
    assert launches >= st.n_ticks > 0
    for k in ("n_ticks", "n_evals", "cache_hits", "cache_misses"):
        assert getattr(st, k) == getattr(want, k), k
    got, ref = card.results(), cpu.results()
    for name, r in ref.items():
        assert seq(got[name]) == seq(r), name
        a, b = r.best_distance.city_block(), got[name].best_distance.city_block()
        assert abs(a - b) <= REL_TOL * max(abs(a), 1e-12), name


@pytest.mark.gpu
def test_store_hit_on_card_is_bit_identical(cuda):
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    db = P.HardwareDatabase()
    bud = P.calibrated_budget(db)
    g = P.ar_complex()
    designs = P.random_single_noc_designs(g, 6, seed=3)
    store = PS.DesignStore()
    tb = P.TorchBatchedBackend(g, db)
    tb.attach_store(store)
    first = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs])
    for h in first:
        h.fitness
    launches = phase_sim_cuda.launches
    again = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs])
    assert phase_sim_cuda.launches == launches  # every row came from the store
    assert store.stats.hits == 6 and store.stats.misses == 6
    for a, b in zip(first, again):
        assert b.fitness == a.fitness
        assert b.scalars() == a.scalars()
        assert b.telemetry().block_bneck_s() == a.telemetry().block_bneck_s()
        assert b.result().task_finish_s == a.result().task_finish_s


@pytest.mark.gpu
def test_kernel_failure_on_card_fails_the_session(cuda, monkeypatch):
    """A phase-sim launch that raises on the card fails its session with the
    fault on ``__cause__``; the CPU fallback never prices it."""
    import repro_torch.kernels.phase_sim.ops as ops

    def broken(*a, **k):
        raise RuntimeError("phase-sim launch failed")

    monkeypatch.setattr(ops, "phase_sim_rows", broken)
    db = P.HardwareDatabase()
    bud = P.calibrated_budget(db)
    svc = PS.DseService(db, retry=PS.RetryPolicy(backoff_s=0.0))
    h = svc.submit("s0", P.ar_complex(), bud, P.ExplorerConfig(seed=0, max_iterations=10))
    st = svc.run()
    assert h.failed and not h.degraded
    assert isinstance(h.error, PS.DispatchFailed)
    assert "phase-sim launch failed" in str(h.error.__cause__)
    assert st.n_degraded == 0 and st.n_degraded_evals == 0 and st.n_failed == 1
    assert svc.scheduler.fallback_backends() == {}
