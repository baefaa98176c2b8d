"""``TorchBatchedBackend`` on the CPU (the plain version of the phase-sim
kernel) against the JAX package's ``JaxBatchedBackend``: fitness, scalars,
telemetry and decoded results on the same designs and moves; the
per-design Python fallback beyond ``MAX_NOC``; ``adopt_encoding``
invalidation; and the bounded shape-key count over a long search."""
import random
from dataclasses import astuple

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import canon_design, population, to_port  # noqa: E402
from repro.core import moves as r_moves  # noqa: E402
from repro_torch.core import moves as p_moves  # noqa: E402

REL_TOL = 1e-5


def rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


def make_candidates(pkg, moves, g, base, budget, n, seed):
    """``n`` recorded-move candidates off one base design, drawn the same
    way for either package (moves never consume the RNG)."""
    rng = random.Random(seed)
    tasks = sorted(g.tasks)
    ck = base.checkpoint()
    out = []
    while len(out) < n:
        move = rng.choice(moves.MOVE_KINDS)
        block = rng.choice(list(base.blocks))
        task = rng.choice(tasks)
        direction = rng.choice([-1, 1])
        delta = moves.MoveDelta()
        ok = moves.apply_move(base, g, move, block, task, direction, "pe", "latency",
                              random.Random(0), delta)
        base.restore(ck)
        if ok and not delta.topology:
            spec = moves.MoveSpec(move, block, task, direction, "pe", "latency")
            out.append(pkg.Candidate(base=base, spec=spec, delta=delta, budget=budget))
    return out


def assert_results_close(a, b, ctx, names=True):
    """Decoded SimResults of the two packages (``names``: block names agree)."""
    assert rel(a.latency_s, b.latency_s) <= REL_TOL, ctx
    for t, f in a.task_finish_s.items():
        assert rel(f, b.task_finish_s[t]) <= REL_TOL, (ctx, t)
    for w, lat in a.workload_latency_s.items():
        assert rel(lat, b.workload_latency_s[w]) <= REL_TOL, (ctx, w)
    for k in ("energy_j", "power_w", "area_mm2", "total_traffic_bytes",
              "avg_accel_parallelism"):
        assert rel(getattr(a, k), getattr(b, k)) <= REL_TOL, (ctx, k)
    assert a.n_phases == b.n_phases, ctx
    assert a.task_bottleneck == b.task_bottleneck, ctx
    for k, s in a.bottleneck_s.items():
        assert abs(s - b.bottleneck_s[k]) <= REL_TOL * a.latency_s, (ctx, k)
    if names:
        assert a.task_bottleneck_block == b.task_bottleneck_block, ctx
        assert a.mem_capacity_bytes == b.mem_capacity_bytes, ctx
        assert set(a.block_bottleneck_s) == set(b.block_bottleneck_s), ctx
        for n, s in a.block_bottleneck_s.items():
            assert abs(s - b.block_bottleneck_s[n]) <= REL_TOL * a.latency_s, (ctx, n)
        for t, e in a.task_energy_j.items():
            assert rel(e, b.task_energy_j[t]) <= REL_TOL, (ctx, t)


@pytest.mark.parametrize("name,n_noc", [("edge_detection", 1), ("ar_complex", 1),
                                        ("audio", 2), ("audio", 3)])
def test_backend_matches_jax_backend_on_designs(name, n_noc):
    rg, pg = getattr(R, name)(), getattr(P, name)()
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    bud_r, bud_p = R.calibrated_budget(rdb), P.calibrated_budget(pdb)
    rds = population(rg, n_noc, 6, seed=3 + n_noc)
    pds = [to_port(d) for d in rds]
    rh = R.JaxBatchedBackend(rg, rdb).evaluate_candidates(
        [R.Candidate.of_design(d, bud_r) for d in rds])
    pb = P.TorchBatchedBackend(pg, pdb, device="cpu")
    ph = pb.evaluate_candidates([P.Candidate.of_design(d, bud_p) for d in pds])
    for i, (a, b) in enumerate(zip(rh, ph)):
        assert rel(a.fitness, b.fitness) <= REL_TOL, i
        sa, sb = a.scalars(), b.scalars()
        assert set(sa) == set(sb)
        for k in sa:
            assert rel(sa[k], sb[k]) <= REL_TOL, (i, k)
        ta, tb = a.telemetry(), b.telemetry()
        assert ta.top_bneck_pe() == tb.top_bneck_pe() and ta.top_bneck_mem() == tb.top_bneck_mem()
        assert rel(ta.comp_s, tb.comp_s) <= REL_TOL and abs(ta.comm_s - tb.comm_s) <= (
            REL_TOL * sa["latency_s"])
        da, db_ = ta.dist(bud_r), tb.dist(bud_p)
        assert rel(da.fitness(0.05), db_.fitness(0.05)) <= REL_TOL, i
        assert da.converged() == db_.converged()
        for t in rg.tasks:
            assert ta.task_bneck(t) == tb.task_bneck(t)
            assert ta.task_bneck_block(t) == tb.task_bneck_block(t)
        assert_results_close(a.result(), b.result(), (name, n_noc, i))
    st = pb.stats()
    assert st.n_fallback == 0 and st.n_batched == 6 and st.n_dispatches == 1


@pytest.mark.parametrize("name", ["ar_complex", "edge_detection"])
def test_backend_matches_jax_backend_on_moved_candidates(name):
    """Candidates off one shared base (one recorded move each) price the
    same through both packages' delta paths, batch fill and decode."""
    rg, pg = getattr(R, name)(), getattr(P, name)()
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    rbase = R.random_single_noc_designs(rg, 1, seed=5)[0]
    pbase = to_port(rbase)
    rc = make_candidates(R, r_moves, rg, rbase, R.calibrated_budget(rdb), 12, seed=7)
    pc = make_candidates(P, p_moves, pg, pbase, P.calibrated_budget(pdb), 12, seed=7)
    assert [astuple(c.spec) for c in rc] == [astuple(c.spec) for c in pc]
    rh = R.JaxBatchedBackend(rg, rdb).evaluate_candidates(rc)
    pb = P.TorchBatchedBackend(pg, pdb, device="cpu")
    ph = pb.evaluate_candidates(pc)
    for i, (a, b) in enumerate(zip(rh, ph)):
        assert rel(a.fitness, b.fitness) <= REL_TOL, i
        assert_results_close(a.result(), b.result(), (name, i), names=False)
        with rc[i].materialized(rg) as rd, pc[i].materialized(pg) as pd:
            assert canon_design(rd) == canon_design(pd), i
    assert pb.stats().n_fallback == 0


def test_fitness_reads_do_not_decode():
    g, db = P.edge_detection(), P.HardwareDatabase()
    bud = P.calibrated_budget(db)
    be = P.TorchBatchedBackend(g, db, device="cpu")
    handles = be.evaluate_candidates(
        [P.Candidate.of_design(d, bud) for d in P.random_single_noc_designs(g, 8, seed=2)])
    fits = [h.fitness for h in handles]
    assert all(h._res is None for h in handles)
    j = min(range(len(fits)), key=fits.__getitem__)
    handles[j].result()
    assert sum(h._res is not None for h in handles) == 1
    s = be.stats()
    assert s.encode_s > 0 and s.dispatch_s > 0 and s.decode_s > 0


def test_fallback_beyond_max_noc():
    """A chain the encoding cannot host is priced by the scalar simulator
    inside the same call, and counted."""
    from repro_torch.core.phase_sim_torch import MAX_NOC

    g, db = P.edge_detection(), P.HardwareDatabase()
    wide = P.Design.base(g)
    for _ in range(MAX_NOC):
        wide.add_block(P.make_noc(), after_noc=wide.noc_chain[-1])
    be = P.TorchBatchedBackend(g, db, device="cpu")
    assert not be.supports(wide)
    single = P.random_single_noc_designs(g, 1, seed=4)[0]
    got = be.evaluate([single, wide])
    ref = P.PythonBackend(g, db).evaluate([single, wide])
    assert got[1].latency_s == ref[1].latency_s  # exact: the same scalar path
    assert rel(ref[0].latency_s, got[0].latency_s) < 1e-4
    s = be.stats()
    assert s.n_fallback == 1 and s.n_batched == 1 and s.n_sims == 2


def test_adopt_encoding_invalidates_on_fallback_winner():
    from repro_torch.core.backend import _ReadyHandle
    from repro_torch.core.phase_sim_torch import EncodedDesign

    g, db = P.edge_detection(), P.HardwareDatabase()
    be = P.TorchBatchedBackend(g, db, device="cpu")
    d = P.random_single_noc_designs(g, 1, seed=3)[0]
    cand = P.Candidate.of_design(d)
    (h,) = be.evaluate_candidates([cand])
    h.result()
    be.adopt_encoding(h)
    assert id(d) in be._adopted
    be.adopt_encoding(_ReadyHandle(h.result(), 0.0, cand))
    assert id(d) not in be._adopted
    (h2,) = be.evaluate_candidates([P.Candidate.of_design(d)])
    assert abs(h2.result().latency_s - h.result().latency_s) < 1e-12
    be.adopt_encoding(h2)
    fresh = EncodedDesign.of(d, g, db, be._enc)
    assert set(be._adopted[id(d)][1].pe_slot) == set(fresh.pe_slot)
    assert set(be._adopted[id(d)][1].mem_slot) == set(fresh.mem_slot)


def test_shape_keys_stay_bounded_over_long_search():
    """200 iterations stay within 4 padded shape keys (row buffers built)."""
    g, db = P.ar_complex(), P.HardwareDatabase()
    bud = P.calibrated_budget(db).scaled(0.25)  # tight: keeps the search running
    ex = P.Explorer(g, db, bud, P.ExplorerConfig(max_iterations=200, seed=9, device="cpu"))
    res = ex.run()
    s = ex.backend.stats()
    assert res.iterations >= 150
    assert s.n_compiles <= 4, s
    assert s.n_batched > 0 and s.n_fallback == 0


def test_make_backend_names_and_default_device():
    g, db = P.audio(), P.HardwareDatabase()
    assert P.make_backend("python", g, db).name == "python"
    assert P.make_backend("torch", g, db, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        P.make_backend("jax", g, db)
    cfg = P.ExplorerConfig()
    assert (cfg.backend, cfg.device) == ("torch", "cuda")
    # no device means the card; without one the backend refuses
    if torch.cuda.is_available():
        assert P.TorchBatchedBackend(g, db).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TorchBatchedBackend(g, db)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.Explorer(g, db, P.calibrated_budget(db), cfg)
