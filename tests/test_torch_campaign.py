"""The port's ``Campaign`` on the CPU (``device="cpu"``): the same grid
through ``repro.core.Campaign`` on the JAX backend and through
``repro_torch.core.Campaign`` gives the same runs (moves exact, distances
within 1e-5 relative) and the same aggregate; with a ``DesignStore`` it
equals the run without one exactly. Then the reference's campaign
invariants (``test_backend_campaign.py``, ``test_serve.py``)."""
import math

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.serve as PS  # noqa: E402
from _torch_helpers import REL_TOL  # noqa: E402

TIMED = ("sim_wall_s_total",)  # wall clock: differs run to run


def seq(res):
    return [(h["iteration"], h["move"], bool(h["accepted"])) for h in res.history]


def grid(pkg, store, **kw):
    db = pkg.HardwareDatabase()
    bud = pkg.calibrated_budget(db)
    camp = pkg.Campaign(db, store=store, **kw)
    for graph in ("audio", "ar_complex"):
        g = getattr(pkg, graph)()
        for pol in ("farsi", "naive_sa"):
            for seed in (0, 1):
                camp.add(f"{graph}.{pol}.s{seed}", g, bud,
                         pkg.ExplorerConfig(policy=pol, seed=seed, max_iterations=10))
    return camp.run()


def close(a, b):
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return abs(a - b) <= REL_TOL * max(abs(a), 1e-12)


@pytest.fixture(scope="module")
def runs():
    return {
        "ref": grid(R, RS.DesignStore(), backend="jax"),
        "port": grid(P, PS.DesignStore(), device="cpu"),
        "port_plain": grid(P, None, device="cpu"),
    }


def test_campaign_matches_reference(runs):
    want, got = runs["ref"], runs["port"]
    assert list(got.runs) == list(want.runs)
    for name, a in want.runs.items():
        b = got.runs[name]
        assert seq(b) == seq(a), name
        assert (b.iterations, b.n_sims, b.converged, b.policy_name) == (
            a.iterations, a.n_sims, a.converged, a.policy_name), name
        assert close(a.best_distance.city_block(), b.best_distance.city_block()), name
    assert sorted(got.aggregate) == sorted(want.aggregate)
    for k, v in want.aggregate.items():
        if k not in TIMED:
            assert close(float(v), float(got.aggregate[k])), k
    assert got.aggregate["cache_hits_total"] == want.aggregate["cache_hits_total"] > 0
    assert got.aggregate["cache_misses_total"] == want.aggregate["cache_misses_total"]
    assert sorted(got.backend_stats) == sorted(want.backend_stats) == ["ar_complex", "audio"]
    for wl, s in want.backend_stats.items():
        t = got.backend_stats[wl]
        assert (t.n_sims, t.n_dispatches, t.n_cache_hits) == (
            s.n_sims, s.n_dispatches, s.n_cache_hits), wl


def test_campaign_with_store_equals_without(runs):
    cached, plain = runs["port"], runs["port_plain"]
    assert plain.aggregate["cache_hits_total"] == 0
    assert 0.0 < cached.aggregate["cache_hit_rate"] <= 1.0
    for name, a in plain.runs.items():
        b = cached.runs[name]
        assert seq(b) == seq(a) and b.n_sims == a.n_sims
        assert b.best_distance.city_block() == a.best_distance.city_block()
        assert b.history[-1]["fitness"] == a.history[-1]["fitness"]
    for k, v in plain.aggregate.items():
        if k not in TIMED and not k.startswith("cache_"):
            assert cached.aggregate[k] == v or (math.isnan(v) and math.isnan(cached.aggregate[k]))


# ---- the reference's campaign invariants, on the port --------------------------
def test_campaign_smoke_two_seeds_two_workloads():
    db = P.HardwareDatabase()
    g_ed, g_au = P.edge_detection(), P.audio()
    bud = P.calibrated_budget(db)
    res = P.Campaign.sweep(db, {"ed": g_ed, "audio": g_au}, bud, seeds=(1, 2),
                           device="cpu", max_iterations=40).run()
    assert set(res.runs) == {"ed.farsi.s1", "ed.farsi.s2", "audio.farsi.s1", "audio.farsi.s2"}
    assert res.aggregate["n_runs"] == 4
    assert res.aggregate["n_converged"] >= 1
    assert res.aggregate["n_sims_total"] == sum(r.n_sims for r in res.runs.values())
    assert set(res.backend_stats) == {"ed", "audio"}
    assert isinstance(res.backend_stats["ed"], P.BackendStats)
    for wl, prefix in (("ed", "ed."), ("audio", "audio.")):
        per_run = sum(r.n_sims for n, r in res.runs.items() if n.startswith(prefix))
        assert res.backend_stats[wl].n_sims == per_run
        assert res.backend_stats[wl].n_dispatches < per_run
    assert res.aggregate["n_sims_total"] == sum(s.n_sims for s in res.backend_stats.values())
    assert res.aggregate["sim_wall_s_total"] > 0.0
    assert res.converged_runs()


def test_campaign_distinct_graphs_same_name_keep_separate_stats():
    db = P.HardwareDatabase()
    g1, g2 = P.edge_detection(), P.edge_detection()
    bud = P.calibrated_budget(db)
    camp = (
        P.Campaign(db, device="cpu")
        .add("a", g1, bud, P.ExplorerConfig(max_iterations=5))
        .add("b", g2, bud, P.ExplorerConfig(max_iterations=5))
    )
    res = camp.run()
    assert set(res.backend_stats) == {"ed", "ed#1"}
    assert res.backend_stats["ed"].n_sims == res.runs["a"].n_sims
    assert res.backend_stats["ed#1"].n_sims == res.runs["b"].n_sims


def test_campaign_duplicate_name_rejected():
    db = P.HardwareDatabase()
    g = P.edge_detection()
    bud = P.calibrated_budget(db)
    camp = P.Campaign(db, device="cpu").add("a", g, bud, P.ExplorerConfig(max_iterations=5))
    with pytest.raises(ValueError):
        camp.add("a", g, bud, P.ExplorerConfig(max_iterations=5))
    # a per-run backend that conflicts with the shared campaign backend is
    # refused rather than silently overridden
    with pytest.raises(ValueError):
        camp.add("b", g, bud, P.ExplorerConfig(max_iterations=5, backend="python"))
    P.Campaign(db, backend="python").add("b", g, bud, P.ExplorerConfig(max_iterations=5))


def test_policy_sweep_over_scenarios():
    """policy_sweep: every policy under every seed on each scenario's own
    graph and budget, one backend per scenario."""
    db = P.HardwareDatabase()
    scen = P.synthetic_family(2, 1, db, min_tasks=8, max_tasks=12)
    res = P.Campaign.policy_sweep(db, scen, policies=("naive_sa", "farsi"), seeds=(0,),
                                  device="cpu", max_iterations=8).run()
    assert set(res.runs) == {f"{s.name}.{p}.s0" for s in scen for p in ("naive_sa", "farsi")}
    assert set(res.policy_iterations()) == {"naive_sa", "farsi"}
    assert len(res.backend_stats) == len(scen)
