"""The port's device chain block (``repro_torch.core.device_explore``) on the
CPU against the JAX package's ``DeviceChainRunner`` (its jitted XLA
``simulate_batch`` path), fed the same designs and seeds:

  * the packed move table and the fresh carry: every column and leaf
    exactly, with the reference's dtypes;
  * chain blocks on audio and ar_complex, the three menus, alloc off and on,
    R ∈ {1, 4, 16}: per chain the sampled rows and the accept flags exactly,
    the fitness trace and the float carry leaves within 1e-5 relative, the
    integer leaves exactly;
  * a carry the reference produced, continued by the port, as the
    reference continues it;
  * ``reconcile_alloc`` of the winner, and ``Explorer.run_chains`` end to
    end, against the reference's."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import canon_design, to_port  # noqa: E402
from repro.core.phase_sim_jax import EncodedDesign as RED  # noqa: E402
from repro_torch.core import device_explore as PD  # noqa: E402
from repro_torch.core.phase_sim_torch import EncodedDesign as PED  # noqa: E402

REL_TOL = 1e-5
GRAPHS = ("audio", "ar_complex")
_RUNNERS = {}


def runners(graph):
    """One reference and one port runner per graph (the reference caches its
    jitted blocks on the runner)."""
    if graph not in _RUNNERS:
        rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
        _RUNNERS[graph] = (
            R.DeviceChainRunner(getattr(R, graph)(), rdb), R.calibrated_budget(rdb),
            P.DeviceChainRunner(getattr(P, graph)(), pdb, device="cpu"), P.calibrated_budget(pdb),
        )
    return _RUNNERS[graph]


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))) if a.size else 0.0


def assert_carry_close(want, got, ctx):
    """Integer leaves exactly, float leaves within 1e-5, same dtypes."""
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            assert rel_err(a, b) <= REL_TOL, (ctx, name, rel_err(a, b))
        else:
            assert np.array_equal(a, b), (ctx, name)


def assert_block_matches(want, got, ctx):
    for i in range(want.move_idx.shape[0]):
        assert got.seq(i) == want.seq(i), (ctx, "chain", i)
    assert got.move_idx.dtype == want.move_idx.dtype
    assert got.accepted.dtype == want.accepted.dtype
    assert rel_err(want.fit_trace, got.fit_trace) <= REL_TOL, ctx
    assert_carry_close(want.carry, got.carry, ctx)
    assert got.winner == want.winner and got.n_moves == want.n_moves


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("alloc,caps", [(False, None), (True, None), (True, (8, 8))])
def test_move_table_and_fresh_carry_match_reference(graph, alloc, caps):
    rr, _, pr, _ = runners(graph)
    for seed in (3, 7):
        d = R.random_single_noc_designs(rr.g, 1, seed=seed)[0]
        pd = to_port(d)
        red, ped = RED.of(d, rr.g, rr.db, rr.enc), PED.of(pd, pr.g, pr.db, pr.enc)
        cp, cm = caps or rr._capacities(red, alloc, None, None, None)
        want = R.MoveTable.of(red, rr.enc, alloc=alloc, cap_pe=cp, cap_mem=cm)
        got = P.MoveTable.of(ped, pr.enc, alloc=alloc, cap_pe=cp, cap_mem=cm)
        for col in ("kind", "task", "dest"):
            a, b = getattr(want, col), getattr(got, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), col
        assert (cp, cm) == pr._capacities(ped, alloc, None, None, None) or caps
        wc = rr.fresh_carry(d, red, 5, seed, cap_pe=cp, cap_mem=cm, alloc=alloc)
        gc = pr.fresh_carry(pd, ped, 5, seed, cap_pe=cp, cap_mem=cm, alloc=alloc)
        for name, a, b in zip(wc._fields, wc, gc):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        # migrate rows onto real slots (padded slots have no block to name)
        rows = np.flatnonzero((want.kind == PD.MV_MIG_MEM) & (want.dest < red.mem_bw.shape[0]))[:3]
        for m in rows:
            a, b = want.delta_of(int(m), rr.enc, red), got.delta_of(int(m), pr.enc, ped)
            assert a.task_mem == b.task_mem and a.task_pe == b.task_pe


# (graph, menu, alloc, R, K): the three menus, alloc off and on, both
# graphs, each population size in {1, 4, 16} on every graph
CASES = []
for gi, graph in enumerate(GRAPHS):
    for mi, menu in enumerate(PD.MENUS):
        for alloc in (False, True):
            r = (1, 4, 16)[(gi + mi + alloc) % 3]
            CASES.append((graph, menu, alloc, r, {1: 32, 4: 24, 16: 16}[r]))


@pytest.mark.parametrize("graph,menu,alloc,r,k", CASES)
def test_chain_block_matches_reference(graph, menu, alloc, r, k):
    rr, rb, pr, pb = runners(graph)
    seed = 7 + r
    d = R.random_single_noc_designs(rr.g, 1, seed=seed)[0]
    want = rr.run_chains(d, rb, r=r, k=k, seed=seed, menu=menu, alloc=alloc)
    got = pr.run_chains(to_port(d), pb, r=r, k=k, seed=seed, menu=menu, alloc=alloc)
    assert int(want.accepted.sum()) > 0
    assert_block_matches(want, got, (graph, menu, alloc, r, k))


@pytest.mark.parametrize("graph,menu", [("audio", "farsi"), ("ar_complex", "telemetry")])
def test_carry_from_reference_continues_as_reference(graph, menu):
    """State carried across: the reference's carry after K = 8 steps, fed to
    the port with it0 = 8, continues as the reference's own continuation."""
    rr, rb, pr, pb = runners(graph)
    d = R.random_single_noc_designs(rr.g, 1, seed=4)[0]
    first = rr.run_chains(d, rb, r=4, k=8, seed=4, menu=menu, alloc=True)
    want = rr.run_chains(d, rb, r=4, k=8, seed=4, it0=8, menu=menu, alloc=True,
                         carry=first.carry)
    carry = PD.ChainCarry(*(np.asarray(x) for x in first.carry))
    got = pr.run_chains(to_port(d), pb, r=4, k=8, seed=4, it0=8, menu=menu, alloc=True,
                        carry=carry)
    assert_block_matches(want, got, (graph, menu))


def test_reconcile_alloc_matches_reference():
    """The winner's platform replayed onto the design: the same clones,
    retunes, re-homes, removals and mapping as the reference's replay."""
    rr, rb, pr, pb = runners("audio")
    d = R.random_single_noc_designs(rr.g, 1, seed=9)[0]
    want = rr.run_chains(d, rb, r=8, k=32, seed=9, menu="farsi", alloc=True)
    got = pr.run_chains(to_port(d), pb, r=8, k=32, seed=9, menu="farsi", alloc=True)
    assert_block_matches(want, got, "reconcile")
    rd, pd = copy.deepcopy(d), to_port(d)
    wo = rr.reconcile_alloc(rd, want)
    go = pr.reconcile_alloc(pd, got)
    assert len(wo["forked"]) == len(go["forked"]) and wo["retuned"] == go["retuned"]
    assert canon_design(rd) == canon_design(pd)
    assert wo["forked"] or wo["removed"] or wo["retuned"]  # the platform changed


@pytest.mark.parametrize("alloc", [False, True])
def test_explorer_run_chains_matches_reference(alloc):
    """``Explorer.run_chains`` on both packages: the same per-step history
    of the winner chain, the same simulation count and reconciled design."""
    def cfg(mod, **kw):
        return mod.ExplorerConfig(policy="device_sa", max_iterations=48, seed=4,
                                  chain_r=8, chain_k=16, chain_alloc=alloc, **kw)

    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    d = R.random_single_noc_designs(R.audio(), 1, seed=5)[0]
    want = R.Explorer(R.audio(), rdb, R.calibrated_budget(rdb),
                      cfg(R, backend="jax")).run_chains(copy.deepcopy(d))
    got = P.Explorer(P.audio(), pdb, P.calibrated_budget(pdb),
                     cfg(P, device="cpu")).run_chains(to_port(d))
    seq = lambda res: [(h["iteration"], h["move"], h["accepted"]) for h in res.history]
    assert seq(got) == seq(want)
    assert rel_err([h["fitness"] for h in want.history],
                   [h["fitness"] for h in got.history]) <= REL_TOL
    assert got.n_sims == want.n_sims and got.chained and got.chain_r == 8
    assert canon_design(got.best_design) == canon_design(want.best_design)
    fa, fb = want.best_distance.fitness(0.05), got.best_distance.fitness(0.05)
    assert abs(fa - fb) <= REL_TOL * max(abs(fa), 1e-12)
