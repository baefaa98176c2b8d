"""Why the port's parity oracle for ``traffic_bytes`` on random task graphs
is the JAX package's eager run, shown on the CPU.

``traffic_bytes`` sums post-drain residues, differences of near-equal
numbers: round one product differently and the column moves past 1e-5
while every other column stays far inside it. The reference's jitted run
rounds differently from its eager run in three named places, which
together reproduce the jitted column: XLA rewrites the nested division
``rem_ops / (peak_eff / load)`` into ``(rem_ops · load) / peak_eff``, and
contracts ``rem_ops − compute·φ`` and ``alp_t + φ·Σ`` into fused
multiply-adds. The variants below are built from the port's own plain
version by rewriting those expressions' source; the port itself computes
the eager semantics. Graphs: ``chip_smoke.random_dag`` (see
``tests/test_torch_random_dags.py``)."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from _torch_helpers import REL_TOL  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402
from test_torch_random_dags import (  # noqa: E402
    FLOAT_KEYS, GRAPHS, RJ, random_dag_rows, ref_graph, rel,
)

_CACHE = {}


def graph(t, seed):
    """(port enc, numpy rows, reference enc, port plain outputs)."""
    if (t, seed) not in _CACHE:
        g, enc, rows = random_dag_rows(t, seed, P.HardwareDatabase())
        plain = PT.simulate_batch(enc, PT.rows_to(rows, "cpu"))
        _CACHE[(t, seed)] = (enc, rows, RJ.EncodedWorkload.of(ref_graph(g)),
                             {k: v.numpy() for k, v in plain.items()})
    return _CACHE[(t, seed)]


def plain_variant(*rewrites):
    """The port's plain version with some of its expressions rounded as the
    reference's jitted run rounds them (kept here, not in the port):

      * ``"dr_ops"``: ``rem_ops − compute·φ`` with one rounding (a fused
        multiply-add: the product exact in f64, the difference rounded once);
      * ``"alp"``: ``alp_t + φ·Σ`` with one rounding;
      * ``"comp_t"``: ``rem_ops / (peak_eff / load)`` as ``(rem_ops · load) /
        peak_eff`` (XLA's algebraic rewrite of a nested division)."""
    fma = "((({c}).double() {op} ({a}).double() * ({b}).double()).float())"
    sites = {
        "dr_ops": ("dr_ops = (rem_ops - d_ops).clamp(min=0.0)",
                   "dr_ops = " + fma.format(c="rem_ops", op="-",
                                            a="torch.where(running, compute, 0.0)",
                                            b="phi[:, None]") + ".clamp(min=0.0)"),
        "alp": ("alp_t = alp_t + phi * (runf / load_t.clamp(min=1.0)).sum(1)",
                "alp_t = " + fma.format(c="alp_t", op="+", a="phi",
                                        b="(runf / load_t.clamp(min=1.0)).sum(1)")),
        "comp_t": ("comp_t = rem_ops / compute",
                   "comp_t = (rem_ops * load_t.clamp(min=1.0)) / peak_eff"),
    }
    src = inspect.getsource(PT.phase_sim_plain)
    for r in rewrites:
        old, new = sites[r]
        assert src.count(old) == 1, r
        src = src.replace(old, new)
    ns = dict(vars(PT))
    exec(src, ns)
    fn = ns["phase_sim_plain"]
    return lambda enc, rows: {k: v.numpy() for k, v in fn(
        enc.on("cpu"), PT.rows_to(rows, "cpu"), len(enc.names)).items()}


def test_reference_jit_and_eager_differ_on_traffic():
    """The reference against itself: on the 100-task graph of seed 1 its
    jitted and eager runs are more than 1e-5 apart on ``traffic_bytes``
    (every other column: ``tests/test_torch_random_dags.py``)."""
    import jax

    enc, rows, renc, _ = graph(100, 1)
    jit = jax.jit(lambda r: RJ.simulate_batch(renc, r))(rows)["traffic_bytes"]
    with jax.disable_jit():
        eager = RJ.simulate_batch(renc, rows)["traffic_bytes"]
    assert rel(np.asarray(eager), np.asarray(jit)) > REL_TOL


def test_traffic_bytes_is_ill_conditioned():
    """Round one product of the plain version differently (``rem_ops −
    compute·φ`` as one fused multiply-add): ``traffic_bytes`` moves past
    1e-5 on some graph, while every other column moves far less."""
    variant = plain_variant("dr_ops")
    moved = {k: 0.0 for k in FLOAT_KEYS}
    for t, s in GRAPHS:
        enc, rows, _, plain = graph(t, s)
        got = variant(enc, rows)
        for k in FLOAT_KEYS:
            moved[k] = max(moved[k], rel(plain[k], got[k]))
    assert moved["traffic_bytes"] > REL_TOL, moved
    assert all(v < 0.2 * REL_TOL for k, v in moved.items() if k != "traffic_bytes"), moved


def test_named_rewrites_reproduce_the_jitted_reference():
    """The sub-expressions the jit rounds differently, named: with the
    nested-division rewrite of ``comp_t`` and the two contractions, the
    plain version lands on the jitted reference's ``traffic_bytes`` to 1e-6
    on every graph; with either one alone it does not."""
    both = plain_variant("comp_t", "dr_ops", "alp")
    worst = {"both": 0.0, "comp_t": 0.0, "dr_ops": 0.0}
    single = {"comp_t": plain_variant("comp_t"), "dr_ops": plain_variant("dr_ops")}
    import jax

    for t, s in GRAPHS:
        enc, rows, renc, _ = graph(t, s)
        jit = {"traffic_bytes": np.asarray(
            jax.jit(lambda r: RJ.simulate_batch(renc, r))(rows)["traffic_bytes"])}
        worst["both"] = max(worst["both"], rel(jit["traffic_bytes"], both(enc, rows)["traffic_bytes"]))
        for name, fn in single.items():
            if worst[name] <= REL_TOL:  # until each alone has missed once
                worst[name] = max(worst[name], rel(jit["traffic_bytes"], fn(enc, rows)["traffic_bytes"]))
    assert worst["both"] < 1e-6, worst
    assert worst["comp_t"] > REL_TOL and worst["dr_ops"] > REL_TOL, worst
