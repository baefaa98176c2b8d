"""The port's own invariants of the device chain block, on the CPU
(``device="cpu"``: the phase-sim kernel's plain version prices), bit for
bit where the reference is bit-exact with itself:

  * MoveTable edge cases: single-slot classes, all-taboo menus, capacity-
    saturated fork masks, the table's structure and ``delta_of`` guard;
  * R = 1 fused block ≡ the host-driven loop (mapping-only and mixed, every
    menu); chain i identical at R = 16 and R = 256 (and 8 / 64 mixed);
  * checkpoint and resume of the carry through ``device_sa``;
  * ``reconcile_alloc``'s round trip re-prices the reconciled design to the
    winner's fitness within 1e-5;
  * the backend's ``run_chains`` accounting and ``Explorer.run_chains``
    end to end; a block cached per shape (``n_compiles``);
  * no host synchronisation inside the block's loop.

Counterparts of the JAX package's ``tests/test_device_alloc.py``,
``tests/test_policy.py`` (device chain block) and
``tests/test_backend_campaign.py`` (device chain blocks)."""
import copy
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import device_explore as PD  # noqa: E402
from repro_torch.core.device_explore import (  # noqa: E402
    MV_FORK_MEM,
    MV_FORK_PE,
    MV_JOIN_PE,
    MV_MIG_MEM,
    MV_MIG_PE,
    MV_SWAP_PE,
)
from repro_torch.core.phase_sim_torch import BIG, EncodedDesign  # noqa: E402

REL_TOL = 1e-5


def _fixture(seed=7, graph="audio"):
    db = P.HardwareDatabase()
    g = getattr(P, graph)()
    bud = P.calibrated_budget(db)
    d = P.random_single_noc_designs(g, 1, seed=seed)[0]
    return g, db, bud, d


def _runner(g, db):
    return P.DeviceChainRunner(g, db, device="cpu")


def _kinds_of(runner, design, *, alloc, cap_pe=None, cap_mem=None):
    """The packed table's kind column, for mapping move_idx → MV_* codes."""
    ed = EncodedDesign.of(design, runner.g, runner.db, runner.enc)
    return P.MoveTable.of(ed, runner.enc, alloc=alloc, cap_pe=cap_pe, cap_mem=cap_mem).kind


def _assert_same_block(a, b, chains=None):
    chains = range(a.move_idx.shape[0]) if chains is None else chains
    for i in chains:
        assert a.seq(i) == b.seq(i), i
    assert np.array_equal(a.fit_trace, b.fit_trace)
    for x, y in zip(a.carry, b.carry):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# MoveTable edge cases
# ---------------------------------------------------------------------------
def test_single_slot_classes_self_mask_every_move():
    """``Design.base`` has one PE and one MEM: mapping-only, every migrate
    row's destination is the task's current slot, so the whole menu is
    self-masked — the block force-rejects throughout (no accepts, fitness
    pinned at the fresh carry's BIG, task maps and taboo untouched)."""
    g, db, bud, _ = _fixture()
    d = P.Design.base(g)
    runner = _runner(g, db)
    res = runner.run_chains(d, bud, r=4, k=8, seed=3)
    assert int(res.accepted.sum()) == 0
    assert np.all(res.fit_trace == np.float32(BIG))
    t = res.task_pe.shape[1]
    assert np.array_equal(res.task_pe, np.zeros((4, t), res.task_pe.dtype))
    assert np.array_equal(res.task_mem, np.zeros((4, t), res.task_mem.dtype))
    # forced rejects must not burn taboo slots on the (unsampleable) menu
    assert int(res.carry.taboo.max()) == 0
    assert runner.n_fallback == 0


def test_movetable_structure_and_delta_guard():
    """Mapping-only tables are pure migrate crosses; ``alloc=True`` adds
    fork crosses, join/swap rows, and (single-NoC design) NO attach rows.
    ``delta_of`` only bridges migrate rows back to host MoveDeltas."""
    g, db, bud, d = _fixture()
    runner = _runner(g, db)
    ed = EncodedDesign.of(d, runner.g, runner.db, runner.enc)
    t = len(runner.enc.names)
    s_pe = int(ed.pe_peak.shape[0])
    s_mem = int(ed.mem_bw.shape[0])
    plain = P.MoveTable.of(ed, runner.enc)
    assert plain.n_moves == t * s_pe + t * s_mem
    assert set(np.unique(plain.kind)) == {MV_MIG_PE, MV_MIG_MEM}
    wide = P.MoveTable.of(ed, runner.enc, alloc=True, cap_pe=8, cap_mem=8)
    kinds = set(int(k) for k in np.unique(wide.kind))
    assert {MV_MIG_PE, MV_MIG_MEM, MV_FORK_PE, MV_FORK_MEM, MV_JOIN_PE, MV_SWAP_PE} <= kinds
    assert all(int(k) <= 7 for k in kinds)  # one NoC: attach rows omitted
    assert np.sum(wide.kind == MV_MIG_PE) == t * 8
    fork_rows = np.flatnonzero(wide.kind == MV_FORK_PE)
    with pytest.raises(ValueError):
        wide.delta_of(int(fork_rows[0]), runner.enc, ed)
    mig_rows = np.flatnonzero(wide.kind == MV_MIG_PE)
    assert wide.delta_of(int(mig_rows[0]), runner.enc, ed) is not None


def test_all_taboo_menu_force_rejects_until_decay():
    """A carry whose taboo column is saturated masks the ENTIRE menu: the
    block force-rejects (no accepts, no state drift, no taboo re-stamping)
    until the counters decay to zero."""
    g, db, bud, d = _fixture(seed=11)
    runner = _runner(g, db)
    warm = runner.run_chains(d, bud, r=4, k=4, seed=2, alloc=True)
    # counters decrement BEFORE the validity check: 4 keeps every row
    # masked for the whole 3-step block (4→3→2→1, never 0)
    frozen = warm.carry._replace(taboo=np.full_like(warm.carry.taboo, 4))
    res = runner.run_chains(d, bud, r=4, k=3, seed=2, it0=4, carry=frozen, alloc=True)
    assert int(res.accepted.sum()) == 0
    assert np.array_equal(res.fit_trace, np.repeat(warm.fitness[:, None], 3, axis=1))
    assert np.array_equal(res.carry.task_pe, warm.carry.task_pe)
    assert np.array_equal(res.carry.task_mem, warm.carry.task_mem)
    assert np.array_equal(res.carry.pe_active, warm.carry.pe_active)
    assert int(res.carry.taboo.max()) == 1 and int(res.carry.taboo.min()) == 1
    assert runner.n_fallback == 0


def test_capacity_saturated_fork_mask():
    """With caps pinned to the real slot counts every slot starts active, so
    no fork row is samplable at step 0 — the validity mask keeps forks out
    (and the explicit-cap path keeps the taboo width equal to the table's)."""
    g, db, bud, d = _fixture(seed=5)
    runner = _runner(g, db)
    ed = EncodedDesign.of(d, runner.g, runner.db, runner.enc)
    s_pe, s_mem = int(ed.pe_peak.shape[0]), int(ed.mem_bw.shape[0])
    res = runner.run_chains(d, bud, r=32, k=1, seed=13, alloc=True, cap_pe=s_pe, cap_mem=s_mem)
    kinds = _kinds_of(runner, d, alloc=True, cap_pe=s_pe, cap_mem=s_mem)
    assert res.carry.taboo.shape[1] == kinds.shape[0]
    sampled = kinds[res.move_idx[:, 0]]
    assert not np.any((sampled == MV_FORK_PE) | (sampled == MV_FORK_MEM))


def test_unknown_menu_and_missing_card_raise():
    g, db, bud, d = _fixture()
    with pytest.raises(ValueError):
        _runner(g, db).run_chains(d, bud, r=1, k=1, menu="nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.DeviceChainRunner(g, db)  # the card is the default, and there is none


# ---------------------------------------------------------------------------
# bit-exact invariants
# ---------------------------------------------------------------------------
def test_device_chain_block_parity_with_host_loop():
    """At R = 1 the fused K-step block replays the host-driven loop (same
    step, one call + one carry round trip per iteration) bit for bit —
    moves, accepts, fitness trace and the full carry."""
    g, db, bud, d = _fixture(seed=7)
    runner = _runner(g, db)
    fused = runner.run_chains(d, bud, r=1, k=16, seed=7)
    host = runner.run_chains_host(d, bud, r=1, n_steps=16, seed=7)
    _assert_same_block(fused, host)
    assert runner.n_fallback == 0


@pytest.mark.parametrize("menu", ["naive_sa", "telemetry", "farsi"])
def test_mixed_block_parity_with_host_loop(menu):
    """The mixed mapping+allocation block at R = 1 replays the host loop bit
    for bit on every menu (active masks, allocation columns, provenance)."""
    g, db, bud, d = _fixture(seed=7)
    runner = _runner(g, db)
    fused = runner.run_chains(d, bud, r=1, k=12, seed=7, menu=menu, alloc=True)
    host = runner.run_chains_host(d, bud, r=1, n_steps=12, seed=7, menu=menu, alloc=True)
    _assert_same_block(fused, host)


def test_mixed_block_samples_allocation_moves():
    """The widened table exercises allocation rows: sampled kinds leave the
    migrate class."""
    g, db, bud, d = _fixture(seed=7)
    runner = _runner(g, db)
    res = runner.run_chains(d, bud, r=16, k=24, seed=7, menu="farsi", alloc=True)
    sampled = _kinds_of(runner, d, alloc=True)[res.move_idx]
    assert np.any(sampled > MV_MIG_MEM), "no allocation move ever sampled"


def test_device_chain_sequence_independent_of_population():
    """Chain keys are fold_in(seed, chain): chain i's sequence is identical
    in an R = 16 and an R = 256 population."""
    g, db, bud, _ = _fixture()
    d = P.random_single_noc_designs(g, 1, seed=11)[0]
    runner = _runner(g, db)
    small = runner.run_chains(d, bud, r=16, k=8, seed=3)
    big = runner.run_chains(d, bud, r=256, k=8, seed=3)
    for chain in (0, 5, 15):
        assert small.seq(chain) == big.seq(chain), chain
    assert np.array_equal(small.fit_trace, big.fit_trace[:16])
    assert np.array_equal(small.task_pe, big.task_pe[:16])
    assert np.array_equal(small.task_mem, big.task_mem[:16])


def test_mixed_chain_sequence_independent_of_population():
    """The same for the widened table: chain i at R = 8 and at R = 64."""
    g, db, bud, d = _fixture(seed=11)
    runner = _runner(g, db)
    small = runner.run_chains(d, bud, r=8, k=8, seed=3, menu="telemetry", alloc=True)
    big = runner.run_chains(d, bud, r=64, k=8, seed=3, menu="telemetry", alloc=True)
    for chain in (0, 3, 7):
        assert small.seq(chain) == big.seq(chain), chain
    assert np.array_equal(small.fit_trace, big.fit_trace[:8])
    assert np.array_equal(small.carry.pe_active, big.carry.pe_active[:8])
    assert np.array_equal(small.carry.task_pe, big.carry.task_pe[:8])


def test_device_sa_checkpoint_restores_device_carry_bitexact():
    """``device_sa`` checkpoints deep-copy the carry: mutating the live carry
    after checkpoint() cannot leak into the snapshot, and a block resumed
    from the restored carry replays the uninterrupted continuation."""
    g, db, bud, _ = _fixture()
    d = P.random_single_noc_designs(g, 1, seed=5)[0]
    runner = _runner(g, db)
    first = runner.run_chains(d, bud, r=4, k=8, seed=9, alloc=True, menu="farsi")
    pol = P.make_policy("device_sa")
    pol.device_carry = PD.copy_carry(first.carry)
    ck = pol.checkpoint()
    snapshot = [np.array(x, copy=True) for x in first.carry]
    ref = runner.run_chains(d, bud, r=4, k=8, seed=9, it0=8, carry=first.carry,
                            alloc=True, menu="farsi")
    for x in pol.device_carry:
        x.fill(0)
    pol.restore(ck)
    for a, b in zip(pol.device_carry, snapshot):
        assert np.array_equal(a, b)
    resumed = runner.run_chains(d, bud, r=4, k=8, seed=9, it0=8, carry=pol.device_carry,
                                alloc=True, menu="farsi")
    _assert_same_block(resumed, ref)
    # and one block of 16 equals two blocks of 8
    whole = runner.run_chains(d, bud, r=4, k=16, seed=9, alloc=True, menu="farsi")
    assert whole.seq(2) == first.seq(2) + ref.seq(2)
    for x, y in zip(whole.carry, ref.carry):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("graph", ["audio", "ar_complex"])
def test_reconcile_alloc_round_trips_to_host_fitness(graph):
    """The winning chain decoded back into a Design (clones, retunes,
    re-homes, removals) re-prices, by the scalar simulator, to the block's
    fitness within 1e-5."""
    g, db, bud, d = _fixture(seed=7, graph=graph)
    runner = _runner(g, db)
    res = runner.run_chains(d, bud, r=8, k=32, seed=9, menu="farsi", alloc=True)
    dev_fit = float(res.fitness[res.winner])
    assert np.isfinite(dev_fit)
    d2 = copy.deepcopy(d)
    out = runner.reconcile_alloc(d2, res)
    assert out["forked"] or out["removed"] or out["retuned"] or out["task_pe"]
    host_fit = P.distance(P.simulate(d2, g, db), bud).fitness(0.05)
    assert abs(host_fit - dev_fit) <= REL_TOL * max(abs(dev_fit), 1e-12)


def test_reconcile_mapping_applies_winner():
    g, db, bud, d = _fixture(seed=3)
    runner = _runner(g, db)
    res = runner.run_chains(d, bud, r=4, k=16, seed=3)
    d2 = copy.deepcopy(d)
    changed = runner.reconcile(d2, res)
    assert changed["task_pe"] or changed["task_mem"]
    enc = runner.enc
    ed = EncodedDesign.of(d2, g, db, enc)
    assert np.array_equal(ed.task_pe, res.task_pe[res.winner])
    assert np.array_equal(ed.task_mem, res.task_mem[res.winner])


# ---------------------------------------------------------------------------
# backend and explorer
# ---------------------------------------------------------------------------
def test_backend_run_chains_accounting_and_flush():
    """``TorchBatchedBackend.run_chains`` prices one fused (R, K) block per
    dispatch and accounts every chain step; handles issued before an
    explicit flush() stay readable after it."""
    g, db, bud, _ = _fixture()
    be = P.TorchBatchedBackend(g, db, device="cpu")
    d = P.random_single_noc_designs(g, 1, seed=5)[0]
    block = be.run_chains(P.ChainRequest(design=d, budget=bud, r=8, k=16, seed=5))
    assert block.fitness.shape == (8,) and block.move_idx.shape == (8, 16)
    stats = be.stats()
    assert stats.n_sims == 8 * 16 and stats.n_batched == 8 * 16
    assert stats.n_dispatches == 1 and stats.n_fallback == 0
    runner = be.chain_runner()
    assert runner.n_fallback == 0 and runner.enc is be._enc and runner.device == be.device
    cands = [P.Candidate.of_design(x) for x in P.random_single_noc_designs(g, 3, seed=2)]
    handles = be.evaluate_candidates(cands)
    be.flush()
    assert all(h.result().latency_s > 0 for h in handles)


def test_explorer_run_chains_e2e():
    """``Explorer.run_chains`` end to end: chained result, per-step
    history, n_sims = R·K per block plus the winner's single decode, one
    cached block for one (R, K) shape."""
    g, db, bud, _ = _fixture()
    be = P.TorchBatchedBackend(g, db, device="cpu")
    ex = P.Explorer(g, db, bud, P.ExplorerConfig(
        policy="device_sa", max_iterations=32, seed=7, chain_r=8, chain_k=16), backend=be)
    res = ex.run_chains()
    assert res.chained and res.chain_r == 8
    assert res.iterations == 32 and len(res.history) == 32
    assert all(h["move"] == "chain_migrate" for h in res.history)
    assert res.n_sims == 8 * 32 + 1
    assert res.best_result.latency_s > 0
    assert be.chain_runner().n_compiles == 1


def test_explorer_chain_alloc_end_to_end():
    """``chain_alloc=True`` runs mixed blocks: history records
    ``chain_mixed`` moves, n_sims counts R·K steps plus the final decode,
    and the reconciled winner's fitness matches the trace's last winner
    fitness within 1e-5."""
    g, db, bud, d = _fixture()
    res = P.Explorer(g, db, bud, P.ExplorerConfig(
        policy="farsi", max_iterations=48, seed=4, chain_r=8, chain_k=16,
        chain_alloc=True, device="cpu")).run_chains(d)
    assert {h["move"] for h in res.history} == {"chain_mixed"}
    assert res.chained and res.chain_r == 8 and res.n_sims == 8 * 48 + 1
    dev_fit = res.history[-1]["fitness"]
    host_fit = res.best_distance.fitness(0.05)
    assert abs(host_fit - dev_fit) <= REL_TOL * max(abs(dev_fit), 1e-12)


def test_explorer_refuses_backend_without_chains():
    g, db, bud, _ = _fixture()
    ex = P.Explorer(g, db, bud, P.ExplorerConfig(chain_r=4, backend="python"))
    with pytest.raises(ValueError, match="chain"):
        ex.run_chains()


def test_block_loop_makes_no_host_sync():
    """The K-step loop and everything it calls per step (the step, the move,
    the draws, the re-pricing wrapper) contain no host synchronisation."""
    from repro_torch.core import prng
    from repro_torch.kernels.phase_sim import chain, kernel, ops

    srcs = [inspect.getsource(f) for f in (
        PD._ChainBlock._step, PD._ChainBlock._apply_move, PD.block_draws, prng.threefry2x32,
        prng.split, prng.random_bits, prng.uniform, prng.gumbel, prng.categorical,
        chain.resimulate_chains, ops.phase_sim, ops.phase_sim_rows, ops.unpack,
        ops.pack_nocs, kernel.phase_sim_cuda,
    )]
    loop = inspect.getsource(PD._ChainBlock.__call__).split("with loop_guard():")[1]
    pat = re.compile(r"\.item\(|\.cpu\(|\.tolist\(|\.numpy\(|synchronize\(|torch\.tensor\(|"
                     r"from_numpy\(|\.to\(\"cpu\"\)")
    assert not [m.group(0) for s in srcs + [loop] for m in pat.finditer(s)]


def test_loop_guard_wraps_the_iterations_alone():
    """The runner's ``loop_guard`` is entered once per block, around its K
    iterations (chip_smoke.py turns host syncs into errors there)."""
    import contextlib

    g, db, bud, d = _fixture()
    runner = _runner(g, db)
    entered = []

    @contextlib.contextmanager
    def guard():
        entered.append(True)
        yield

    runner.loop_guard = guard
    runner.run_chains(d, bud, r=2, k=4, seed=1)
    runner.run_chains_host(d, bud, r=1, n_steps=3, seed=1)
    assert len(entered) == 4
