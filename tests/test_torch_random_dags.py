"""The port's plain phase simulator on random task graphs against the JAX
package's ``simulate_batch``, and why one column is held against the
reference's eager run.

The graphs (``chip_smoke.random_dag``): T ∈ {40, 64, 100} tasks, seeds 0–2,
each earlier task a parent with p = 0.08, work 1e5–1e7 ops, intensities
1–16; 16 designs from ``random_single_noc_designs`` each.

``traffic_bytes`` sums post-drain residues, differences of near-equal
numbers, so one rounding anywhere upstream moves it past 1e-5. The
reference's jitted run rounds differently from its eager run in named
places (``tests/test_torch_traffic_conditioning.py``): XLA rewrites the nested division ``rem_ops / (peak_eff / load)``
into ``(rem_ops · load) / peak_eff``, and contracts ``rem_ops − compute·φ``
(and ``alp_t + φ·Σ``) into fused multiply-adds. The port computes the
reference's eager semantics; its bar for ``traffic_bytes`` on these graphs
is therefore the eager run, and every other column stays held against the
jitted run. The bar itself is unchanged: 1e-5 relative on every column,
codes, phase counts and argmaxes exact."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import CHECK_KEYS, INT_DTYPES, REL_TOL  # noqa: E402
from repro.core import phase_sim_jax as RJ  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import RANDOM_DAG_SEEDS, RANDOM_DAG_TASKS, random_dag_rows  # noqa: E402

GRAPHS = [(t, s) for t in RANDOM_DAG_TASKS for s in RANDOM_DAG_SEEDS]
FLOAT_KEYS = tuple(k for k in CHECK_KEYS if k not in INT_DTYPES)
_CACHE = {}


def ref_graph(g):
    """The port's graph rebuilt in the JAX package."""
    rg = R.TaskGraph(g.name)
    for n, t in g.tasks.items():
        rg.add_task(R.Task(n, t.work_ops, t.i_read, t.i_write, t.llp, t.burst_bytes))
    for n in g.tasks:
        for p in g.parents[n]:
            rg.add_edge(p, n)
    return rg


def case(t, seed):
    """(port enc, numpy rows, reference jitted outputs, reference eager
    outputs, port plain outputs), once per graph."""
    if (t, seed) not in _CACHE:
        import jax

        g, enc, rows = random_dag_rows(t, seed, P.HardwareDatabase())
        renc = RJ.EncodedWorkload.of(ref_graph(g))
        jit = jax.jit(lambda r: RJ.simulate_batch(renc, r))(rows)
        with jax.disable_jit():
            eager = RJ.simulate_batch(renc, rows)
        plain = PT.simulate_batch(enc, PT.rows_to(rows, "cpu"))
        _CACHE[(t, seed)] = (
            enc, rows, {k: np.asarray(v) for k, v in jit.items()},
            {k: np.asarray(v) for k, v in eager.items()}, {k: v.numpy() for k, v in plain.items()},
        )
    return _CACHE[(t, seed)]


def rel(want, got):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))) if a.size else 0.0


@pytest.mark.parametrize("t,seed", GRAPHS)
def test_plain_matches_reference(t, seed):
    """Every column within 1e-5 of the reference's eager run; every column
    but ``traffic_bytes`` also within 1e-5 of its jitted run; codes, phase
    counts and argmaxes exactly equal to both."""
    _, _, jit, eager, got = case(t, seed)
    for k in CHECK_KEYS:
        assert got[k].shape == eager[k].shape, k
        if k in INT_DTYPES:
            assert got[k].dtype == INT_DTYPES[k], k
            assert np.array_equal(got[k], eager[k]) and np.array_equal(got[k], jit[k]), k
            continue
        assert rel(eager[k], got[k]) <= REL_TOL, (k, rel(eager[k], got[k]))
        if k != "traffic_bytes":
            assert rel(jit[k], got[k]) <= REL_TOL, (k, rel(jit[k], got[k]))
    # the reference against itself: its jitted and eager runs agree to 1e-5
    # on every column but traffic_bytes (PERF.md records the spread)
    for k in FLOAT_KEYS:
        if k != "traffic_bytes":
            assert rel(eager[k], jit[k]) <= REL_TOL, (k, rel(eager[k], jit[k]))
