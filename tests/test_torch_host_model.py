"""The PyTorch port's host model equals the JAX package's: task graphs, the
hardware database, base and moved designs, every move kind's recorded
delta, the scalar phase simulator and the shared layout tuples.

The port keeps its own copies of these framework-free modules (it imports
nothing of ``repro``), so these tests are what keeps the copies honest.
Block names come from per-package counters, so designs are compared in a
canonical form (blocks by insertion index) or translated name for name."""
import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import canon_design, to_port  # noqa: E402
from repro.core import moves as r_moves  # noqa: E402
from repro_torch.core import moves as p_moves  # noqa: E402

GRAPHS = ("audio", "ar_complex", "syn0")


def graph_pair(name):
    """The same task graph built by each package (and a budget for it)."""
    if name == "syn0":
        rs = R.synthetic_family(0, 6)
        ps = P.synthetic_family(0, 6)
        return [s.tdg for s in rs], [s.tdg for s in ps], [(a.budget, b.budget) for a, b in zip(rs, ps)]
    return [getattr(R, name)()], [getattr(P, name)()], []


def canon_graph(g):
    tasks = [dataclasses.asdict(t) for t in g.tasks.values()]
    return (g.name, tasks, dict(g.parents), dict(g.children), dict(g.edge_bytes))


def canon_delta(delta, before, after):
    """A MoveDelta with block names resolved to indices of the design
    before the move (removals) or after it (everything else)."""
    ib = {n: i for i, n in enumerate(before.blocks)}
    ia = {n: i for i, n in enumerate(after.blocks)}
    return (
        sorted((t, ia[p]) for t, p in delta.task_pe.items()),
        sorted((t, ia[m]) for t, m in delta.task_mem.items()),
        sorted((ia.get(n, ib.get(n)), b.signature()) for n, b in delta.touched.items()),
        [b.signature() for b in delta.added],
        [ib[n] for n in delta.removed],
        sorted((ia[b], ia[n]) for b, n in delta.attached.items()),
        None if delta.noc_after is None else ia.get(delta.noc_after, ib.get(delta.noc_after)),
        delta.topology,
    )


@pytest.mark.parametrize("name", GRAPHS)
def test_task_graphs_identical(name):
    rgs, pgs, buds = graph_pair(name)
    for rg, pg in zip(rgs, pgs):
        assert canon_graph(rg) == canon_graph(pg)
        assert rg.topo_order() == pg.topo_order()
        for t in rg.tasks:
            assert rg.parallel_tasks_of(t) == pg.parallel_tasks_of(t), t
    for rb, pb in buds:
        assert rb.latency_s == pb.latency_s
        assert (rb.power_w, rb.area_mm2) == (pb.power_w, pb.area_mm2)


def test_database_and_budgets_identical():
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    assert dataclasses.asdict(rdb.energy) == dataclasses.asdict(pdb.energy)
    assert dataclasses.asdict(rdb.area) == dataclasses.asdict(pdb.area)
    g = R.ar_complex()
    for t, task in g.tasks.items():
        for unroll in (1, 4, 64):
            assert rdb.a_peak(t, task.llp, unroll) == pdb.a_peak(t, task.llp, unroll)
    for fn in ("calibrated_budget", "paper_budget"):
        rb = getattr(R, fn)(rdb) if fn == "calibrated_budget" else getattr(R, fn)()
        pb = getattr(P, fn)(pdb) if fn == "calibrated_budget" else getattr(P, fn)()
        assert (rb.latency_s, rb.power_w, rb.area_mm2) == (pb.latency_s, pb.power_w, pb.area_mm2)


def test_layout_tuples_identical():
    from repro.core import phase_sim_jax as RJ
    from repro.core import scal_layout as RS
    from repro.kernels.phase_sim import kernel as RK
    from repro_torch.core import phase_sim_torch as PT
    from repro_torch.core import scal_layout as PS
    from repro_torch.kernels.phase_sim import kernel as PK

    assert PS.SCAL_COLS == RS.SCAL_COLS and PS.N_SCAL == RS.N_SCAL == 14
    assert (PS.KIND_START, PS.KIND_STOP, PS.TOP_PE_COL, PS.TOP_MEM_COL) == (
        RS.KIND_START, RS.KIND_STOP, RS.TOP_PE_COL, RS.TOP_MEM_COL)
    assert PT.ROW_KEYS == RJ.ROW_KEYS
    assert PT.ENCODED_FIELDS == RJ.ENCODED_FIELDS
    assert PT.MAX_NOC == RJ.MAX_NOC == PK.MAX_NOC
    assert PK.NOCS_COLS == RK.NOCS_COLS
    assert r_moves.MOVE_KINDS == p_moves.MOVE_KINDS


@pytest.mark.parametrize("name", GRAPHS)
def test_base_and_random_designs_simulate_identically(name):
    """Design.base and the random population are the same designs, and the
    scalar simulator prices them to the same floats, field by field."""
    rgs, pgs, _ = graph_pair(name)
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    for rg, pg in zip(rgs, pgs):
        assert canon_design(R.Design.base(rg)) == canon_design(P.Design.base(pg))
        rds = R.random_single_noc_designs(rg, 4, seed=11)
        pds = P.random_single_noc_designs(pg, 4, seed=11)
        for rd, pd in zip(rds, pds):
            assert canon_design(rd) == canon_design(pd)
            want = R.simulate(rd, rg, rdb)
            got = P.simulate(to_port(rd), pg, pdb)
            assert dataclasses.asdict(want) == dataclasses.asdict(got)


@pytest.mark.parametrize("move", r_moves.MOVE_KINDS)
def test_moves_and_deltas_identical(move):
    """Every move kind, applied with the same arguments and RNG state to the
    same design, leaves the same design and records the same delta."""
    rg, pg = R.ar_complex(), P.ar_complex()
    tasks = sorted(rg.tasks)
    rng = random.Random(31)
    applied = 0
    for d in R.random_single_noc_designs(rg, 6, seed=19):
        pd = to_port(d)
        for _ in range(8):
            block = rng.choice(list(d.blocks))
            args = (
                block, rng.choice(tasks), rng.choice([-1, 1]),
                rng.choice(["pe", "mem", "noc"]), rng.choice(["latency", "power", "area"]),
            )
            rbefore, pbefore = d.clone(rename=False), pd.clone(rename=False)
            rck, pck = d.checkpoint(), pd.checkpoint()
            rdel, pdel = r_moves.MoveDelta(), p_moves.MoveDelta()
            rok = r_moves.apply_move(d, rg, move, *args, random.Random(5), rdel)
            pok = p_moves.apply_move(pd, pg, move, *args, random.Random(5), pdel)
            assert rok == pok, (move, args)
            if rok:
                assert canon_design(d) == canon_design(pd), (move, args)
                assert canon_delta(rdel, rbefore, d) == canon_delta(pdel, pbefore, pd)
                applied += 1
            d.restore(rck)
            pd.restore(pck)
            assert canon_design(d) == canon_design(pd)
    assert applied >= 3, f"move {move!r} never applied: test vacuous"


def test_seeded_explorer_histories_identical_on_python_backend():
    """The scalar Python backend drives the same search in both packages
    (policy, taboo, RNG draws and the accept test are host code)."""
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    rr = R.Explorer(R.edge_detection(), rdb, R.calibrated_budget(rdb),
                    R.ExplorerConfig(max_iterations=20, seed=3, backend="python")).run()
    pr = P.Explorer(P.edge_detection(), pdb, P.calibrated_budget(pdb),
                    P.ExplorerConfig(max_iterations=20, seed=3, backend="python")).run()
    strip = lambda h: {k: v for k, v in h.items() if k != "wall_s"}
    assert [strip(h) for h in rr.history] == [strip(h) for h in pr.history]
    assert rr.n_sims == pr.n_sims
    assert canon_design(rr.best_design) == canon_design(pr.best_design)
