"""Shared helpers of the PyTorch-port tests (``tests/test_torch_*.py``):
design populations built by the JAX package, their translation into the
port, and the column-by-column comparison of simulator outputs."""
import dataclasses
import random

import numpy as np

import repro.core as R
import repro_torch.core as P
from repro.core.blocks import make_accelerator, make_mem
from repro.core.moves import apply_fork

REL_TOL = 1e-5  # the reference's own bar: kernel vs oracle, every column
# every output the kernel must reproduce (the reference's _CHECK_KEYS) plus
# the per-block bottleneck telemetry the policies read
CHECK_KEYS = (
    "latency_s", "finish_s", "bneck_code", "bneck_kind_s", "alp_time_s",
    "traffic_bytes", "n_phases", "wl_latency_s", "energy_j", "power_w",
    "area_mm2", "fitness", "all_done", "pe_bneck_s", "mem_bneck_s",
    "noc_bneck_s", "top_bneck_pe", "top_bneck_mem",
)
INT_DTYPES = {"bneck_code": np.int32, "n_phases": np.int32, "top_bneck_pe": np.int32,
              "top_bneck_mem": np.int32, "all_done": np.bool_}


def assert_same_config(port, ref) -> None:
    """The port's ``ModelConfig`` holds every field of the reference's,
    value for value, and each field of the port's own (``ssm_groups``,
    ``moe_router``, ...) at its default, which is the reference's
    behaviour."""
    theirs, mine = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert {k: mine[k] for k in theirs} == theirs
    own = [f for f in dataclasses.fields(port) if f.name not in theirs]
    assert own and {f.name: mine[f.name] for f in own} == {f.name: f.default for f in own}


def chain_designs(g, n_noc: int, count: int, seed: int = 0):
    """``count`` reference designs with an ``n_noc``-deep chain, built as the
    explorer builds them: real NoC forks on a randomized single-NoC design,
    then random remapping so routes span the chain."""
    rng = random.Random(seed)
    tasks = sorted(g.tasks)
    out = []
    for _ in range(count):
        d = R.Design.base(g)
        noc0 = d.noc_chain[0]
        for _ in range(rng.randint(2, 4)):
            if rng.random() < 0.5:
                t = rng.choice(tasks)
                b = d.add_block(make_accelerator(t, rng.choice((100, 400))), attach_to=noc0)
                d.task_pe[t] = b.name
            else:
                d.add_block(make_mem(rng.choice(("dram", "sram")), rng.choice((100, 800)), 32),
                            attach_to=noc0)
        while len(d.noc_chain) < n_noc:
            assert apply_fork(d, g, rng.choice(d.noc_chain))
        pes, mems = d.pes(), d.mems()
        for t in tasks:
            d.task_pe[t] = rng.choice(pes)
            d.task_mem[t] = rng.choice(mems)
        assert len(d.noc_chain) == n_noc
        out.append(d)
    return out


def population(g, n_noc: int, count: int, seed: int):
    """Reference designs: random single-NoC designs, or forked chains."""
    if n_noc == 1:
        return R.random_single_noc_designs(g, count, seed=seed)
    return chain_designs(g, n_noc, count, seed=seed)


def to_port(d):
    """The reference design rebuilt in the port, block names kept."""
    out = P.Design()
    for n, b in d.blocks.items():
        out.blocks[n] = P.Block(
            kind=P.BlockKind(b.kind.value), subtype=b.subtype, freq_mhz=b.freq_mhz,
            width_bytes=b.width_bytes, n_links=b.n_links, unroll=b.unroll,
            hardened_for=b.hardened_for, name=n,
        )
    out.noc_chain = list(d.noc_chain)
    out.attached_noc = dict(d.attached_noc)
    out.task_pe = dict(d.task_pe)
    out.task_mem = dict(d.task_mem)
    return out


def canon_design(d):
    """Name-free form of a design of either package: blocks by insertion
    index (block names come from per-package counters)."""
    idx = {n: i for i, n in enumerate(d.blocks)}
    return (
        [b.signature() for b in d.blocks.values()],
        [idx[n] for n in d.noc_chain],
        sorted((idx[k], idx[v]) for k, v in d.attached_noc.items()),
        sorted((t, idx[p]) for t, p in d.task_pe.items()),
        sorted((t, idx[m]) for t, m in d.task_mem.items()),
    )


def workload_arrays(enc):
    """A reference EncodedWorkload's arrays as numpy (``from_reference``'s
    ``workload`` argument)."""
    keys = ("work_ops", "read_bytes", "write_bytes", "burst", "llp", "parent_mask", "wl_id")
    return {k: np.asarray(getattr(enc, k)) for k in keys}


def reference_rows(g, n_noc: int, batch: int, seed: int):
    """A reference encoding and budgeted rows for ``batch`` designs."""
    from repro.core import phase_sim_jax as RJ

    db = R.HardwareDatabase()
    bud = R.calibrated_budget(db)
    enc = RJ.EncodedWorkload.of(g)
    rows = RJ.encode_batch(population(g, n_noc, batch, seed), g, db, enc)
    for j in range(batch):
        RJ.fill_budget(rows, j, enc, bud.latency_s, bud.power_w, bud.area_mm2, 0.05)
    return enc, rows


def assert_outputs_close(got, want, ctx="", keys=CHECK_KEYS, tol=REL_TOL):
    """Every column within ``tol`` relative; integer outputs keep their
    dtypes (and, being codes and counts, agree exactly)."""
    for k in keys:
        a = np.asarray(want[k])
        b = got[k].numpy() if hasattr(got[k], "numpy") else np.asarray(got[k])
        assert a.shape == b.shape, (ctx, k, a.shape, b.shape)
        if k in INT_DTYPES:
            assert b.dtype == INT_DTYPES[k], (ctx, k, b.dtype)
            assert np.array_equal(a, b), (ctx, k)
            continue
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        rel = np.max(np.abs(a64 - b64) / np.maximum(np.abs(a64), 1e-12)) if a.size else 0.0
        assert rel <= tol, (ctx, k, rel)
