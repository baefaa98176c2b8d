"""The port's flat design encoding equals the JAX package's bit for bit:
from-scratch ``encode_batch`` rows, ``apply_delta`` for every move kind
(NoC fork/join included), and the typed refusal beyond ``MAX_NOC``."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import population, to_port, workload_arrays  # noqa: E402
from repro.core import phase_sim_jax as RJ  # noqa: E402
from repro.core.moves import MOVE_KINDS, MoveDelta, apply_move  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402
from repro_torch.core.moves import MoveDelta as PortDelta  # noqa: E402

_FIELDS = PT.ENCODED_FIELDS + ("noc_pj",)


def assert_same_encoding(got, want, ctx):
    for f in _FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        assert np.array_equal(a, b), (ctx, f, a, b)
    assert got.pe_slot == want.pe_slot and got.mem_slot == want.mem_slot, ctx
    assert got.noc_slot == want.noc_slot, ctx


def assert_same_rows(got, want, ctx=""):
    assert set(got) == set(want) == set(PT.ROW_KEYS), ctx
    for k in PT.ROW_KEYS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k)
        assert np.array_equal(a, b), (ctx, k)


@pytest.mark.parametrize("name", ["audio", "ar_complex", "edge_detection"])
def test_workload_encoding_identical(name):
    renc = RJ.EncodedWorkload.of(getattr(R, name)())
    penc = PT.EncodedWorkload.of(getattr(P, name)())
    ref = workload_arrays(renc)
    for k, a in ref.items():
        b = getattr(penc, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (penc.names, penc.wl_names, penc.index) == (renc.names, renc.wl_names, renc.index)


@pytest.mark.parametrize("n_noc", [1, 2, 3])
def test_encode_batch_rows_identical(n_noc):
    """From-scratch rows of a mixed population, padded to forced counts."""
    rg, pg = R.audio(), P.audio()
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    designs = population(rg, n_noc, 6, seed=3 + n_noc)
    want = RJ.encode_batch(designs, rg, rdb, RJ.EncodedWorkload.of(rg), n_pe=16, n_mem=8, n_noc=4)
    got = PT.encode_batch([to_port(d) for d in designs], pg, pdb, PT.EncodedWorkload.of(pg),
                          n_pe=16, n_mem=8, n_noc=4)
    assert_same_rows(got, want, n_noc)
    bud = R.calibrated_budget(rdb)
    for j in range(len(designs)):
        RJ.fill_budget(want, j, RJ.EncodedWorkload.of(rg), bud.latency_s, bud.power_w,
                       bud.area_mm2, 0.05)
        PT.fill_budget(got, j, PT.EncodedWorkload.of(pg), bud.latency_s, bud.power_w,
                       bud.area_mm2, 0.05)
    assert_same_rows(got, want, "budget")


@pytest.mark.parametrize("move", MOVE_KINDS)
def test_apply_delta_identical_per_move_kind(move):
    """Every move kind on the reference design; the reference's delta is
    replayed onto both packages' base encodings (the port's delta carries
    port Blocks, made field for field from the reference's) and the port's
    result also equals its own from-scratch encode of the moved design."""
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    rg, pg = R.ar_complex(), P.ar_complex()
    renc, penc = RJ.EncodedWorkload.of(rg), PT.EncodedWorkload.of(pg)
    tasks = sorted(rg.tasks)
    rng = random.Random(23)
    applied = 0
    for i, d in enumerate(R.random_single_noc_designs(rg, 6, seed=17)):
        pd = to_port(d)
        rbase = RJ.EncodedDesign.of(d, rg, rdb, renc)
        pbase = PT.EncodedDesign.of(pd, pg, pdb, penc)
        assert_same_encoding(pbase, rbase, (move, i))
        for trial in range(8):
            args = (
                rng.choice(list(d.blocks)), rng.choice(tasks), rng.choice([-1, 1]),
                rng.choice(["pe", "mem", "noc"]), rng.choice(["latency", "power", "area"]),
            )
            ck = d.checkpoint()
            delta = MoveDelta()
            if not apply_move(d, rg, move, *args, random.Random(0), delta):
                d.restore(ck)
                continue
            want_moved = RJ.EncodedDesign.of(d, rg, rdb, renc)
            got_moved = PT.EncodedDesign.of(to_port(d), pg, pdb, penc)
            assert_same_encoding(got_moved, want_moved, (move, i, trial, "scratch"))
            d.restore(ck)
            want = RJ.apply_delta(rbase, delta, d, rg, rdb, renc)
            got = PT.apply_delta(pbase, port_delta(delta), to_port(d), pg, pdb, penc)
            assert_same_encoding(got, want, (move, i, trial))
            assert_same_encoding(got, want_moved, (move, i, trial, "delta"))
            applied += 1
    assert applied >= 3, f"move {move!r} never applied: test vacuous"


def port_delta(delta):
    """The reference's MoveDelta with port Blocks (names kept)."""

    def blk(b):
        return P.Block(kind=P.BlockKind(b.kind.value), subtype=b.subtype, freq_mhz=b.freq_mhz,
                       width_bytes=b.width_bytes, n_links=b.n_links, unroll=b.unroll,
                       hardened_for=b.hardened_for, name=b.name)

    return PortDelta(
        task_pe=dict(delta.task_pe), task_mem=dict(delta.task_mem),
        touched={n: blk(b) for n, b in delta.touched.items()},
        added=[blk(b) for b in delta.added], removed=list(delta.removed),
        attached=dict(delta.attached), noc_after=delta.noc_after, topology=delta.topology,
    )


def test_unsupported_beyond_max_noc():
    g = P.edge_detection()
    db = P.HardwareDatabase()
    wide = P.Design.base(g)
    for _ in range(PT.MAX_NOC):  # a chain of MAX_NOC + 1
        wide.add_block(P.make_noc(), after_noc=wide.noc_chain[-1])
    with pytest.raises(PT.UnsupportedDesignError):
        PT.EncodedDesign.of(wide, g, db, PT.EncodedWorkload.of(g))
    with pytest.raises(PT.UnsupportedDesignError):
        PT.encode_batch([wide], g, db, PT.EncodedWorkload.of(g))
    with pytest.raises(PT.UnsupportedDesignError):
        PT.apply_delta(None, PortDelta(topology=True), wide, g, db,
                       PT.EncodedWorkload.of(g))
    # MAX_NOC itself still encodes
    wide.remove_block(wide.noc_chain[-1])
    ed = PT.EncodedDesign.of(wide, g, db, PT.EncodedWorkload.of(g))
    assert ed.noc_bw.shape == (PT.MAX_NOC,)


def test_from_reference_checks_keys_and_dtypes():
    rg = R.audio()
    renc = RJ.EncodedWorkload.of(rg)
    rows = RJ.encode_batch(R.random_single_noc_designs(rg, 3, seed=1), rg, R.HardwareDatabase(),
                           renc)
    wl = workload_arrays(renc)
    enc, dev = PT.from_reference(wl, renc.names, renc.wl_names, rows, "cpu")
    assert enc.names == renc.names and enc.index == renc.index
    for k in PT.ROW_KEYS:
        assert dev[k].device.type == "cpu"
        assert np.array_equal(dev[k].numpy(), rows[k]), k
    bad = dict(rows)
    bad["task_pe"] = bad["task_pe"].astype(np.int64)
    with pytest.raises(TypeError):
        PT.from_reference(wl, renc.names, renc.wl_names, bad, "cpu")
    with pytest.raises(KeyError):
        PT.from_reference(wl, renc.names, renc.wl_names,
                          {k: v for k, v in rows.items() if k != "alpha"}, "cpu")
    with pytest.raises(TypeError):
        PT.from_reference({**wl, "work_ops": wl["work_ops"].astype(np.float64)},
                          renc.names, renc.wl_names, rows, "cpu")
    with pytest.raises(KeyError):
        PT.from_reference({k: v for k, v in wl.items() if k != "llp"},
                          renc.names, renc.wl_names, rows, "cpu")
