"""The port's serve fault-tolerance layer on the CPU (``device="cpu"``).

First against the reference: one ``FaultInjector`` seed gives the same
injection schedule, the same ``counts()``, the same service counters and the
same terminal state per session in ``repro.serve`` (JAX backend) and in
``repro_torch.serve``. Then the reference's chaos sweep
(``test_serve_faults.py``), held by the port: no exception escapes
``DseService.run()``, replay is deterministic, untouched sessions are
bit-identical to a fault-free run, and the retry, degradation, restart,
deadline, non-finite and straggler paths hold."""
import math
import time

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.serve as PS  # noqa: E402
from _torch_helpers import REL_TOL  # noqa: E402

N = 4  # sessions per chaos run
ITERS = 12
FAST_RETRY = PS.RetryPolicy(backoff_s=0.0)  # no real sleeping inside retries
COMBINED = dict(dispatch_fault_rate=0.1, nan_row_rate=0.05, straggler_rate=0.05,
                straggler_delay_s=0.001, crash_rate=0.02)


def seq(res):
    return [(h["iteration"], h["move"], bool(h["accepted"])) for h in res.history]


# ---- the port against the reference ----------------------------------------
def chaos(pkg, svc_pkg, graph, seed, rates, n, **svc_kw):
    db = pkg.HardwareDatabase()
    bud = pkg.calibrated_budget(db)
    g = getattr(pkg, graph)()
    fi = svc_pkg.FaultInjector(seed=seed, **rates)
    svc = svc_pkg.DseService(db, faults=fi, retry=svc_pkg.RetryPolicy(backoff_s=0.0),
                             **svc_kw)
    extra = {"backend": "jax"} if pkg is R else {"device": "cpu"}
    handles = [
        svc.submit(f"s{i}", g, bud, pkg.ExplorerConfig(seed=i, max_iterations=12, **extra),
                   max_restarts=2)
        for i in range(n)
    ]
    return fi, svc, handles, svc.run()


@pytest.mark.parametrize("graph,seed,rates", [
    ("audio", 7, COMBINED),
    ("ar_complex", 7, COMBINED),
    ("audio", 3, dict(dispatch_fault_rate=0.3, nan_row_rate=0.1)),
])
def test_fault_schedule_matches_reference(graph, seed, rates):
    rfi, rsvc, rh, rst = chaos(R, RS, graph, seed, rates, 6, backend="jax")
    fi, svc, h, st = chaos(P, PS, graph, seed, rates, 6, device="cpu")
    assert [(f.tick, f.kind, f.target) for f in fi.schedule] == [
        (f.tick, f.kind, f.target) for f in rfi.schedule]
    assert fi.counts() == rfi.counts() and sum(fi.counts().values()) > 0
    for k in ("n_done", "n_failed", "n_ticks", "n_evals", "n_degraded", "n_degraded_evals",
              "n_restarts", "n_retries", "n_dispatch_faults", "n_bisects",
              "n_nonfinite_rejected", "cache_hits", "cache_misses"):
        assert getattr(st, k) == getattr(rst, k), k
    for a, b in zip(rh, h):
        assert (b.state, b.degraded) == (a.state, a.degraded), a.name
        assert type(b.error).__name__ == type(a.error).__name__, a.name
        if a.done:
            ra, rb = a.result, b.result
            assert seq(rb) == seq(ra), a.name
            assert rb.iterations == ra.iterations and rb.n_sims == ra.n_sims
            da, db_ = ra.best_distance.city_block(), rb.best_distance.city_block()
            assert abs(da - db_) <= REL_TOL * max(abs(da), 1e-12), a.name


def test_fault_injector_draws_like_reference():
    """The injector alone: the same seed and rates draw the same decisions
    at the same points."""
    def drive(mod):
        fi = mod.FaultInjector(seed=11, dispatch_fault_rate=0.3, straggler_rate=0.2,
                               crash_rate=0.1, nan_row_rate=0.25, max_faults=40)
        out = []
        for t in range(1, 30):
            fi.begin_tick(t)
            out.append((fi.draw_dispatch_fault("shared:g"), fi.draw_straggler("shared:g"),
                        fi.draw_crash(f"s{t % 3}"),
                        [type(x).__name__ for x in fi.poison_rows("s0", [object()] * 3)]))
        return out, [(f.tick, f.kind, f.target) for f in fi.schedule], fi.counts()

    assert drive(PS) == drive(RS)


# ---- the reference's chaos sweep, on the port --------------------------------
@pytest.fixture(scope="module")
def db():
    return P.HardwareDatabase()


@pytest.fixture(scope="module")
def g(db):
    return P.edge_detection()


@pytest.fixture(scope="module")
def bud(db):
    return P.calibrated_budget(db)


def _cfg(i):
    return P.ExplorerConfig(seed=i, device="cpu", max_iterations=ITERS)


def _run(db, g, bud, faults=None, n=N, backend="torch", retry=FAST_RETRY, **submit_kw):
    svc = PS.DseService(db, backend=backend, faults=faults, retry=retry, device="cpu")
    handles = [svc.submit(f"s{i}", g, bud, _cfg(i), **submit_kw) for i in range(n)]
    stats = svc.run()  # the headline guarantee: this must never raise
    return svc, handles, stats


def _distances(svc):
    return {n: r.best_distance.city_block() for n, r in svc.results().items()}


@pytest.fixture(scope="module")
def baseline(db, g, bud):
    """Fault-free reference results for the bit-identity assertions."""
    svc, handles, stats = _run(db, g, bud, faults=None, n=6)
    assert stats.n_done == 6 and stats.n_failed == 0
    assert stats.n_dispatch_faults == 0 and stats.n_nonfinite_rejected == 0
    return _distances(svc)


@pytest.mark.parametrize(
    "kind,rates",
    [
        ("dispatch", dict(dispatch_fault_rate=0.3)),
        ("nan_row", dict(nan_row_rate=0.15)),
        ("straggler", dict(straggler_rate=0.3, straggler_delay_s=0.001)),
        ("crash", dict(crash_rate=0.05)),
        ("combined", COMBINED),
    ],
)
def test_chaos_sweep_no_service_crash(db, g, bud, kind, rates):
    fi = PS.FaultInjector(seed=7, **rates)
    svc, handles, stats = _run(db, g, bud, faults=fi, max_restarts=2)
    counts = fi.counts()
    assert svc.n_live == 0
    assert stats.n_done + stats.n_failed == N
    for h in handles:
        assert h.done or h.failed
        if h.failed:
            assert h.error is not None
            with pytest.raises(PS.SessionFailed):
                h.result
    assert stats.n_dispatch_faults == counts["dispatch"]
    assert stats.n_nonfinite_rejected <= counts["nan_row"]
    assert stats.n_restarts + sum(
        1 for h in handles if h.failed and isinstance(h.error, PS.InjectedSessionCrash)
    ) <= counts["crash"]
    for h in handles:
        if h.done:
            assert math.isfinite(h.result.best_distance.city_block())


def test_deterministic_replay(db, g, bud):
    def go():
        fi = PS.FaultInjector(seed=7, **COMBINED)
        svc, handles, stats = _run(db, g, bud, faults=fi, max_restarts=2)
        seqs = {name: seq(r) for name, r in svc.results().items()}
        return fi.schedule, _distances(svc), seqs, stats

    sched_a, dist_a, seq_a, st_a = go()
    sched_b, dist_b, seq_b, st_b = go()
    assert sched_a == sched_b
    assert dist_a == dist_b
    assert seq_a == seq_b
    assert (st_a.n_dispatch_faults, st_a.n_restarts, st_a.n_failed) == (
        st_b.n_dispatch_faults, st_b.n_restarts, st_b.n_failed)


def test_unaffected_sessions_bit_identical(db, g, bud, baseline):
    fi = PS.FaultInjector(seed=1, nan_row_rate=0.03, crash_rate=0.01)
    svc, handles, stats = _run(db, g, bud, faults=fi, n=6, max_restarts=1)
    affected = fi.affected_sessions() | set(svc.failures())
    affected |= {name for name, s in svc._sessions.items() if s.degraded}
    unaffected = [name for name in baseline if name not in affected]
    assert len(unaffected) >= 2
    got = _distances(svc)
    for name in unaffected:
        assert got[name] == baseline[name]


def test_transient_dispatch_faults_are_invisible(db, g, bud, baseline):
    fi = PS.FaultInjector(seed=0, dispatch_fault_rate=1.0, max_faults=3)
    svc, handles, stats = _run(db, g, bud, faults=fi)
    assert stats.n_done == N and stats.n_failed == 0
    assert stats.n_dispatch_faults == 3 == fi.counts()["dispatch"]
    assert stats.n_bisects == 1
    assert stats.n_retries >= 1
    assert stats.n_degraded == 0
    for name, d in _distances(svc).items():
        assert d == baseline[name]


def test_degradation_ladder(db, g, bud):
    fi = PS.FaultInjector(seed=0, dispatch_fault_rate=1.0)
    svc, handles, stats = _run(db, g, bud, faults=fi)
    assert stats.n_done == N and stats.n_failed == 0
    assert stats.n_degraded == N
    assert all(h.degraded and h.done for h in handles)
    assert stats.n_dispatch_faults == 1 + N * FAST_RETRY.degrade_after
    assert stats.n_dispatch_faults == fi.counts()["dispatch"]
    assert stats.n_degraded_evals > 0
    bstats = svc.backend_stats()
    assert bstats["ed~degraded"].n_sims == stats.n_degraded_evals
    assert bstats["ed"].n_sims == 0


def _broken_service(db, g, bud):
    """A one-session service on the CPU whose batched dispatch raises on its
    own, not through the injector."""
    svc = PS.DseService(db, retry=FAST_RETRY, device="cpu")
    h = svc.submit("s0", g, bud, _cfg(0))
    (backend,) = svc.scheduler.backends().values()

    def broken(rows, *a, **k):
        raise RuntimeError("kernel launch failed")

    backend._evaluate_batch = broken
    return svc, h, backend


def test_real_dispatch_failure_enters_the_ladder(db, g, bud):
    """On a backend that prices on the CPU, a dispatch that raises on its own
    is counted and degrades its session to the scalar fallback, also on
    the CPU: the reference's ladder."""
    svc, h, backend = _broken_service(db, g, bud)
    stats = svc.run()
    assert h.done and h.degraded
    assert stats.n_degraded == 1 and stats.n_dispatch_faults == 1 + FAST_RETRY.degrade_after
    assert stats.n_bisects == 1 and stats.n_degraded_evals > 0


def test_real_dispatch_failure_on_the_card_fails_loudly(db, g, bud):
    """A real fault of a backend on the card (a kernel that does not build or
    launch) fails its session with the fault on ``__cause__``, and nothing is
    priced on the CPU: no degradation, no fallback backend built. The backend
    is told it sits on the card; its broken dispatch never reads a tensor."""
    svc, h, backend = _broken_service(db, g, bud)
    backend.device = torch.device("cuda")
    stats = svc.run()
    assert h.failed and not h.degraded
    assert isinstance(h.error, PS.DispatchFailed)
    assert isinstance(h.error.__cause__, RuntimeError)
    assert "kernel launch failed" in str(h.error.__cause__)
    with pytest.raises(PS.SessionFailed):
        h.result
    assert stats.n_failed == 1 and stats.n_degraded == 0 and stats.n_degraded_evals == 0
    assert stats.n_dispatch_faults == 2 and stats.n_bisects == 1 and stats.n_retries == 0
    assert svc.scheduler.fallback_backends() == {}


def test_injected_fault_on_the_card_still_degrades(db, g, bud):
    """Injected faults model a flaky dispatch, not a broken kernel: on a
    backend on the card they still walk the ladder to the scalar fallback."""
    fi = PS.FaultInjector(seed=0, dispatch_fault_rate=1.0)
    svc = PS.DseService(db, faults=fi, retry=FAST_RETRY, device="cpu")
    h = svc.submit("s0", g, bud, _cfg(0))
    (backend,) = svc.scheduler.backends().values()
    backend.device = torch.device("cuda")
    stats = svc.run()
    assert h.done and h.degraded and stats.n_failed == 0
    assert stats.n_degraded == 1 and stats.n_dispatch_faults == 1 + FAST_RETRY.degrade_after


def test_chain_session_degrades_to_host_loop_bit_identically(db, g, bud):
    def chain_cfg():
        return P.ExplorerConfig(policy="device_sa", seed=3, max_iterations=16, chain_r=4,
                                chain_k=8, chain_alloc=True, device="cpu")

    ref_svc = PS.DseService(db, retry=FAST_RETRY, device="cpu")
    ref = ref_svc.submit("chain", g, bud, chain_cfg())
    ref_stats = ref_svc.run()
    assert ref_stats.n_done == 1 and ref_stats.n_degraded == 0
    assert ref.result.chained

    fi = PS.FaultInjector(seed=0, dispatch_fault_rate=1.0)
    svc = PS.DseService(db, faults=fi, retry=FAST_RETRY, device="cpu")
    h = svc.submit("chain", g, bud, chain_cfg())
    stats = svc.run()
    assert stats.n_done == 1 and stats.n_failed == 0
    assert stats.n_degraded == 1 and h.degraded and h.done
    assert stats.n_dispatch_faults == FAST_RETRY.degrade_after
    res = h.result
    assert res.chained and res.chain_r == 4
    hist = [(e["iteration"], e["move"], e["accepted"], e["fitness"]) for e in res.history]
    ref_hist = [(e["iteration"], e["move"], e["accepted"], e["fitness"])
                for e in ref.result.history]
    assert hist == ref_hist


def test_crash_restart_resumes_from_committed_state(db, g, bud, baseline):
    fi = PS.FaultInjector(seed=0, crash_rate=1.0, max_faults=1)
    svc, handles, stats = _run(db, g, bud, faults=fi, n=2, max_restarts=1)
    assert stats.n_done == 2 and stats.n_failed == 0
    assert stats.n_restarts == 1 == fi.counts()["crash"]
    assert _distances(svc)["s0"] == baseline["s0"]


def test_crash_without_restart_budget_fails_session(db, g, bud):
    fi = PS.FaultInjector(seed=0, crash_rate=1.0, max_faults=1)
    svc, handles, stats = _run(db, g, bud, faults=fi, n=2)
    assert stats.n_failed == 1 and stats.n_restarts == 0
    assert handles[0].failed
    assert isinstance(handles[0].error, PS.InjectedSessionCrash)
    assert handles[1].done


def test_deadline_exceeded_surfaces_on_handle(db, g, bud):
    svc = PS.DseService(db, device="cpu")
    doomed = svc.submit("doomed", g, bud, _cfg(0), deadline_s=0.0)
    ok = svc.submit("ok", g, bud, _cfg(1))
    stats = svc.run()
    assert stats.n_deadline_exceeded == 1 and stats.n_failed == 1
    assert doomed.failed and isinstance(doomed.error, PS.DeadlineExceeded)
    with pytest.raises(PS.SessionFailed) as ei:
        doomed.result
    assert isinstance(ei.value.__cause__, PS.DeadlineExceeded)
    assert ok.done and stats.n_done == 1


def test_nan_rows_rejected_never_accepted(db, g, bud):
    fi = PS.FaultInjector(seed=3, nan_row_rate=0.3)
    svc, handles, stats = _run(db, g, bud, faults=fi)
    assert stats.n_done == N and stats.n_failed == 0
    injected = fi.counts()["nan_row"]
    assert injected > 0
    assert 0 < stats.n_nonfinite_rejected <= injected
    for h in handles:
        assert math.isfinite(h.result.best_distance.city_block())
        for e in h.events:
            assert math.isfinite(e.distance) and math.isfinite(e.fitness)


def test_straggler_ticks_flagged_by_monitor(db, g, bud):
    fi = PS.FaultInjector(seed=1, straggler_rate=0.25, straggler_delay_s=0.4)
    svc, handles, stats = _run(db, g, bud, faults=fi, n=3, backend="python")
    assert stats.n_done == 3 and stats.n_failed == 0
    straggler_ticks = {f.tick for f in fi.schedule if f.kind == "straggler"}
    assert straggler_ticks
    flagged = {s.step for s in svc.scheduler.monitor.flagged}
    assert flagged & straggler_ticks
    assert stats.n_straggler_ticks == len(flagged) >= 1


def test_step_time_monitor_and_heartbeat(tmp_path):
    """The port's runtime.health: warm-up, EMA and outlier flagging as the
    reference computes them; heartbeat files name the dead hosts."""
    from repro.runtime import health as RH
    from repro_torch.runtime import health as H

    steps = [0.01, 0.012, 0.011, 0.01, 0.05, 0.011, 0.2, 0.01]
    mons = (H.StepTimeMonitor(), RH.StepTimeMonitor())
    for i, d in enumerate(steps):
        a, b = (m.record(i, d) for m in mons)
        assert (a.is_straggler, a.ema_s) == (b.is_straggler, b.ema_s)
    assert [s.step for s in mons[0].flagged] == [4, 6]
    H.Heartbeat(str(tmp_path), 3).beat(1)
    now = time.time()
    assert H.Heartbeat.dead_hosts(str(tmp_path), 60.0, now=now) == []
    assert H.Heartbeat.dead_hosts(str(tmp_path), 60.0, now=now + 120) == [3]
