"""The port's serve layer on the CPU (``device="cpu"``): the same requests
through ``repro.serve`` on the JAX backend and through ``repro_torch.serve``
give byte-equal store keys, the same accepted moves, ticks, simulation
counts and cache counters, and best distances within the reference's 1e-5
relative bar. Then the reference's own serve invariants (``test_serve.py``),
held by the port: bit-identical cache hits, LRU eviction with pending
entries pinned, mid-flight joins, the best-event stream, session isolation,
chain-batched sessions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.serve as PS  # noqa: E402
from _torch_helpers import REL_TOL, to_port  # noqa: E402
from repro.core.phase_sim_jax import EncodedDesign as RED  # noqa: E402
from repro.core.phase_sim_jax import EncodedWorkload as REW  # noqa: E402
from repro_torch.core.backend import Candidate, _TorchBatch  # noqa: E402
from repro_torch.core.phase_sim_torch import EncodedDesign, EncodedWorkload  # noqa: E402
from repro_torch.serve.store import _Entry  # noqa: E402

POLICIES = ("farsi", "naive_sa", "bottleneck", "locality")


def rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


def seq(res):
    return [(h["iteration"], h["move"], bool(h["accepted"])) for h in res.history]


def record_keys(store):
    """Record every cache key the backends compute through ``store``."""
    keys = []
    key_of = store.key_of

    def rec(ed, wl, bd):
        k = key_of(ed, wl, bd)
        keys.append(k)
        return k

    store.key_of = rec
    return keys


def serve(pkg, svc_pkg, graph, n, iters, chain, late=0, **svc_kw):
    """``n`` host-loop sessions (policies × seeds, replicas included), ``late``
    of them admitted after three ticks, plus an optional chain-batched one."""
    db = pkg.HardwareDatabase()
    bud = pkg.calibrated_budget(db)
    g = getattr(pkg, graph)()
    store = svc_pkg.DesignStore()
    keys = record_keys(store)
    svc = svc_pkg.DseService(db, store=store, **svc_kw)
    extra = {"backend": "jax"} if pkg is R else {"device": "cpu"}

    def submit(i):
        cfg = pkg.ExplorerConfig(policy=POLICIES[i % 4], seed=(i // 4) % 2,
                                 max_iterations=iters, **extra)
        return svc.submit(f"s{i}", g, bud, cfg)

    handles = [submit(i) for i in range(n - late)]
    if chain:
        handles.append(svc.submit("chain", g, bud, pkg.ExplorerConfig(
            policy="farsi", seed=3, max_iterations=16, chain_r=4, chain_k=8,
            chain_alloc=True, **extra)))
    for _ in range(3):
        svc.step()
    handles += [submit(i) for i in range(n - late, n)]
    stats = svc.run()
    return svc, handles, stats, keys


# ---- the port against the reference ---------------------------------------
@pytest.mark.parametrize("graph,chain", [("audio", True), ("ar_complex", False)])
def test_service_matches_reference(graph, chain):
    ref_svc, ref_h, ref_st, ref_keys = serve(R, RS, graph, 8, 12, chain, late=2,
                                             backend="jax")
    svc, got_h, st, keys = serve(P, PS, graph, 8, 12, chain, late=2, device="cpu")
    # store keys: byte-equal, in the same order (designs and move deltas)
    assert len(keys) == len(ref_keys) > 0
    assert keys == ref_keys
    for a, b in zip(ref_h, got_h):
        ra, rb = a.result, b.result
        assert seq(rb) == seq(ra), a.name
        assert (rb.iterations, rb.n_sims, rb.converged) == (ra.iterations, ra.n_sims,
                                                            ra.converged), a.name
        assert rel(ra.best_distance.city_block(), rb.best_distance.city_block()) <= REL_TOL
        assert rel(ra.history[-1]["fitness"], rb.history[-1]["fitness"]) <= REL_TOL
    for k in ("n_sessions", "n_done", "n_ticks", "n_evals", "n_fallback", "cache_hits",
              "cache_misses", "cache_bypasses", "cache_evictions", "n_failed", "n_degraded"):
        assert getattr(st, k) == getattr(ref_st, k), k
    assert st.cache_hits > 0 and st.n_failed == 0
    (bs,) = svc.backend_stats().values()
    (rbs,) = ref_svc.backend_stats().values()
    for k in ("n_sims", "n_dispatches", "n_batched", "n_cache_hits", "n_cache_misses",
              "n_cache_bypass"):
        assert getattr(bs, k) == getattr(rbs, k), k


@pytest.mark.parametrize("graph", ["audio", "ar_complex"])
def test_store_digests_byte_equal(graph):
    """workload_digest, budget_digest and key_of read the same bytes in both
    packages: the same designs give the same keys."""
    rg, pg = getattr(R, graph)(), getattr(P, graph)()
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    renc, penc = REW.of(rg), EncodedWorkload.of(pg)
    penc.on("cpu")  # the device copy must not enter the digest
    wl = RS.DesignStore.workload_digest(renc)
    assert PS.DesignStore.workload_digest(penc) == wl
    for bud in (R.calibrated_budget(rdb), None):
        pbud = P.calibrated_budget(pdb) if bud is not None else None
        for alpha in (0.05, 0.1):
            assert (PS.DesignStore.budget_digest(pbud, alpha)
                    == RS.DesignStore.budget_digest(bud, alpha))
    bd = RS.DesignStore.budget_digest(R.calibrated_budget(rdb), 0.05)
    for d in R.random_single_noc_designs(rg, 6, seed=3):
        want = RS.DesignStore.key_of(RED.of(d, rg, rdb, renc), wl, bd)
        got = PS.DesignStore.key_of(EncodedDesign.of(to_port(d), pg, pdb, penc), wl, bd)
        assert got == want


# ---- DesignStore (the reference's invariants) -----------------------------
@pytest.fixture(scope="module")
def db():
    return P.HardwareDatabase()


@pytest.fixture(scope="module")
def g(db):
    return P.edge_detection()


@pytest.fixture(scope="module")
def bud(db):
    return P.calibrated_budget(db)


def _force(handles):
    for h in handles:
        h.fitness  # one host pull per batch


def _backend(g, db, store):
    tb = P.TorchBatchedBackend(g, db, device="cpu")
    tb.attach_store(store)
    return tb


def test_cache_hit_bit_identical(db, g, bud):
    """A store hit serves the memoized row of an earlier identical dispatch:
    fitness, PPA scalars and telemetry are bit-identical, and no rows are
    dispatched for a fully-hitting batch."""
    designs = P.random_single_noc_designs(g, 6, seed=3)
    store = PS.DesignStore()
    tb = _backend(g, db, store)
    first = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs])
    _force(first)
    assert store.stats.misses == 6 and store.stats.hits == 0
    batched = tb.stats().n_batched
    again = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs])
    s = tb.stats()
    assert s.n_cache_hits == 6 and store.stats.hits == 6
    assert store.stats.misses == 6 and s.n_batched == batched  # nothing dispatched
    for a, b in zip(first, again):
        assert b.fitness == a.fitness  # bit-identical, not approx
        assert b.scalars() == a.scalars()
        assert b.telemetry().block_bneck_s() == a.telemetry().block_bneck_s()
        assert b.result().task_finish_s == a.result().task_finish_s


def test_within_batch_alias_dedupes(db, g, bud):
    """Identical candidates inside ONE dispatch share a single row."""
    d = P.random_single_noc_designs(g, 1, seed=2)[0]
    store = PS.DesignStore()
    tb = _backend(g, db, store)
    got = tb.evaluate_candidates([Candidate.of_design(d, bud) for _ in range(3)])
    assert store.stats.misses == 1 and store.stats.hits == 2
    assert tb.stats().n_batched == 1
    assert got[1].fitness == got[0].fitness == got[2].fitness


def test_alias_adopts_the_consumers_encoding(db, g, bud):
    """A same-dispatch alias carries the consumer's own encoding, and
    adopt_encoding reads it (the row owner's may name other blocks)."""
    d1 = P.random_single_noc_designs(g, 1, seed=2)[0]
    d2 = d1.clone()
    tb = _backend(g, db, PS.DesignStore())
    h1, h2 = tb.evaluate_candidates([Candidate.of_design(d1, bud),
                                     Candidate.of_design(d2, bud)])
    assert h2._batch is h1._batch and h2._j == h1._j and h2._ed is not None
    tb.adopt_encoding(h2)
    base, ed = tb._adopted[id(d2)]
    assert base is d2 and ed is h2._ed and ed is not h1._batch.eds[h1._j]


def test_store_eviction_respects_capacity(db, g, bud):
    """LRU eviction under a capacity bound, deferred past the producing
    dispatch: entries whose batch is still in flight are pinned."""
    with pytest.raises(ValueError):
        PS.DesignStore(capacity=0)
    designs = P.random_single_noc_designs(g, 8, seed=3)
    store = PS.DesignStore(capacity=4)
    tb = _backend(g, db, store)
    _force(tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs]))
    assert len(store) == 8 and store.stats.evictions == 0
    assert store.stats.misses == 8
    again = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs[4:]])
    assert store.stats.hits == 4 and tb.stats().n_cache_hits == 4
    assert len(store) == 4 and store.stats.evictions == 4
    _force(again)


def test_store_eviction_pins_pending_entries(db, g, bud):
    """Entries pending on a ``_TorchBatch`` that is not yet consumed survive
    capacity pressure and serve bit-identical hits once it lands; a
    materialized entry holds a copy, not a view of the batch's output."""
    designs = P.random_single_noc_designs(g, 4, seed=5)
    store = PS.DesignStore(capacity=2)
    tb = _backend(g, db, store)
    first = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs])
    batch = first[0]._batch
    assert isinstance(batch, _TorchBatch) and not batch.consumed
    assert len(store) == 4 and store.stats.evictions == 0
    _force(first)
    assert batch.consumed
    again = tb.evaluate_candidates([Candidate.of_design(d, bud) for d in designs[2:]])
    assert store.stats.hits == 2 and len(store) == 2 and store.stats.evictions == 2
    for a, b in zip(first[2:], again):
        assert b.fitness == a.fitness
        assert b.scalars() == a.scalars()
        for col in b._batch.host().values():
            assert not np.shares_memory(col, batch.out.numpy())


def test_entry_materialize_copies_rows():
    """``_Entry`` copies its row out of the producing batch's columns."""
    out = np.arange(12, dtype=np.float32).reshape(3, 4)

    class Batch:
        consumed = True

        def host(self):
            return {"a": out[:, 1], "b": out[:, 2:]}

    row = _Entry(Batch(), 1).materialize()
    assert row["a"].shape == (1,) and row["b"].shape == (1, 2)
    assert row["a"][0] == 5.0 and list(row["b"][0]) == [6.0, 7.0]
    assert not any(np.shares_memory(v, out) for v in row.values())


def test_key_excludes_block_names(db, g, bud):
    """Pure content addressing: renaming a block changes no array leaf."""
    d = P.random_single_noc_designs(g, 1, seed=4)[0]
    enc = EncodedWorkload.of(g)
    ed = EncodedDesign.of(d, g, db, enc)
    wl = PS.DesignStore.workload_digest(enc)
    bd = PS.DesignStore.budget_digest(bud, 0.05)
    k1 = PS.DesignStore.key_of(ed, wl, bd)
    d.rename_block(d.pes()[0], "totally_new_name")
    assert PS.DesignStore.key_of(EncodedDesign.of(d, g, db, enc), wl, bd) == k1
    assert PS.DesignStore.budget_digest(None, 0.05) != bd


# ---- continuous batching --------------------------------------------------
def test_service_defaults_to_the_card(db, monkeypatch):
    """With no card, a service, a scheduler or a campaign asked for the
    default device raises instead of pricing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PS.DseService(db), lambda: PS.ContinuousBatchScheduler(db),
                 lambda: P.Campaign(db)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert PS.DseService(db, device="cpu").scheduler.device == torch.device("cpu")
    PS.DseService(db, backend="python")  # the scalar backend needs no card


def test_midflight_join_matches_solo(db, g, bud):
    """A session admitted mid-flight walks the exact accepted-move sequence
    of the same config run alone."""
    cfg = dict(seed=5, max_iterations=30, device="cpu")
    solo = P.Explorer(g, db, bud, P.ExplorerConfig(**cfg)).run()
    svc = PS.DseService(db, device="cpu")
    svc.submit("warm", g, bud, P.ExplorerConfig(seed=11, max_iterations=45, device="cpu"))
    for _ in range(6):
        svc.step()
    joiner = svc.submit("joiner", g, bud, P.ExplorerConfig(**cfg))
    svc.run()
    got = joiner.result
    assert seq(got) == seq(solo)
    assert got.best_distance.city_block() == solo.best_distance.city_block()
    assert got.iterations == solo.iterations


def test_best_event_stream(db, g, bud):
    svc = PS.DseService(db, device="cpu")
    h = svc.submit("s", g, bud, P.ExplorerConfig(seed=1, max_iterations=25, device="cpu"))
    svc.run()
    assert h.done and len(h.events) >= 1
    dists = [e.distance for e in h.events]
    assert all(b < a for a, b in zip(dists, dists[1:]))
    assert h.result.best_distance.city_block() <= dists[-1] + 1e-12
    e = h.events[-1]
    assert e.session == "s" and e.latency_s > 0 and e.area_mm2 > 0


def test_repeated_scenario_serve(db):
    """The reference's repeated-scenario run, cut to 16 sessions: replicas
    (same policy, same seed) end bit-identically, the cache hit rate tops
    0.3, nothing falls back."""
    g = P.audio()
    bud = P.calibrated_budget(db)
    svc = PS.DseService(db, device="cpu")
    handles = [
        svc.submit(f"r{rep}.{pol}", g, bud, P.ExplorerConfig(
            seed=rep % 2, policy=pol, max_iterations=12, device="cpu"))
        for rep in range(4) for pol in POLICIES
    ]
    stats = svc.run()
    assert stats.n_done == 16 and all(h.done for h in handles)
    assert stats.n_fallback == 0
    assert stats.cache_hit_rate > 0.3
    assert stats.latency_percentile(95) >= stats.latency_percentile(50) > 0
    for i in range(8):  # r0/r2 and r1/r3 share seeds
        a, b = handles[i].result, handles[i + 8].result
        assert a.best_distance.city_block() == b.best_distance.city_block()
        assert seq(a) == seq(b)


def test_duplicate_session_name_rejected(db, g, bud):
    svc = PS.DseService(db, device="cpu")
    svc.submit("same", g, bud, P.ExplorerConfig(seed=0, max_iterations=5, device="cpu"))
    with pytest.raises(ValueError):
        svc.submit("same", g, bud, P.ExplorerConfig(seed=1, max_iterations=5, device="cpu"))
    svc.run()


def test_coroutine_death_is_quarantined(db, g, bud):
    """An exception escaping one session's coroutine fails exactly that
    session; co-batched sessions run to completion."""
    svc = PS.DseService(db, device="cpu")
    doomed = svc.submit("doomed", g, bud, P.ExplorerConfig(seed=3, max_iterations=15,
                                                           device="cpu"))
    healthy = svc.submit("healthy", g, bud, P.ExplorerConfig(seed=4, max_iterations=15,
                                                             device="cpu"))
    svc.step()
    svc.step()
    boom = RuntimeError("policy blew up mid-iteration")

    def explode(*a, **k):
        raise boom

    svc._sessions["doomed"].explorer.policy.select_focus = explode
    stats = svc.run()
    assert doomed.failed and doomed.error is boom and doomed.state == "failed"
    with pytest.raises(PS.SessionFailed):
        doomed.result
    assert healthy.done and not healthy.failed and healthy.result.iterations > 0
    assert stats.n_failed == 1 and stats.n_done == 1
    assert svc.failures() == {"doomed": boom}


def test_chain_batched_session_coexists_with_host_sessions(db, g, bud):
    """A chain-batched session's blocks go through the backend's chain block,
    never the shared pack; both kinds of session complete."""
    svc = PS.DseService(db, device="cpu")
    chain = svc.submit("chain", g, bud, P.ExplorerConfig(
        policy="device_sa", seed=3, max_iterations=32, chain_r=8, chain_k=16, device="cpu"))
    host = svc.submit("host", g, bud, P.ExplorerConfig(seed=4, max_iterations=15,
                                                       device="cpu"))
    stats = svc.run()
    assert stats.n_done == 2 and stats.n_failed == 0
    res = chain.result
    assert res.chained and res.chain_r == 8 and res.iterations == 32
    assert not host.result.chained
    assert all(np.isfinite(e.fitness) for e in chain.events)
    (backend,) = svc.scheduler.backends().values()
    assert backend.chain_runner().n_compiles >= 1
