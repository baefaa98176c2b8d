"""The port's explorer on the CPU (``TorchBatchedBackend(device="cpu")``)
drives the same search as the JAX package's explorer on its batched
backend: identical accepted-move sequence and simulation count. The slow
case replays every recorded golden cell that the JAX backend replays."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import canon_design  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_policy_seqs.json")
with open(GOLDEN) as f:
    _GOLD = json.load(f)
JAX_CELLS = sorted(k for k, v in _GOLD.items() if "jax" in v["backends"])
GRAPH_FNS = {"audio": "audio", "ar_complex": "ar_complex", "ed": "edge_detection"}


def seq(res):
    return [[h["iteration"], h["move"], int(h["accepted"])] for h in res.history]


def run_port(graph, awareness, seed, iters, policy=""):
    db = P.HardwareDatabase()
    ex = P.Explorer(getattr(P, graph)(), db, P.calibrated_budget(db), P.ExplorerConfig(
        awareness=awareness, policy=policy, max_iterations=iters, seed=seed, device="cpu"))
    return ex, ex.run()


@pytest.mark.parametrize("graph,awareness,seed,iters,policy", [
    ("audio", "farsi", 7, 40, ""),
    ("ar_complex", "farsi", 3, 30, ""),
    ("edge_detection", "farsi", 1, 30, "bottleneck"),
    ("edge_detection", "sa", 5, 40, "locality"),
])
def test_explorer_matches_jax_explorer(graph, awareness, seed, iters, policy):
    rdb = R.HardwareDatabase()
    want = R.Explorer(getattr(R, graph)(), rdb, R.calibrated_budget(rdb), R.ExplorerConfig(
        awareness=awareness, policy=policy, max_iterations=iters, seed=seed,
        backend="jax")).run()
    ex, got = run_port(graph, awareness, seed, iters, policy)
    assert seq(got) == seq(want)
    assert got.n_sims == want.n_sims
    assert got.converged == want.converged and got.iterations == want.iterations
    assert canon_design(got.best_design) == canon_design(want.best_design)
    fa, fb = want.history[-1]["fitness"], got.history[-1]["fitness"]
    assert abs(fa - fb) <= 1e-5 * max(abs(fa), 1e-12)
    st = ex.backend.stats()
    assert got.backend_name == "torch" and st.n_fallback == 0
    assert 0 < st.n_dispatches <= got.iterations + 1  # one per iteration at most


def test_explorer_best_design_reprices_to_last_fitness():
    """The check the smoke run makes on the card, here on the CPU: the best
    design re-priced by the scalar simulator gives the search's fitness."""
    ex, res = run_port("ar_complex", "farsi", 1, 60)
    db = P.HardwareDatabase()
    fit = P.distance(P.simulate(res.best_design, P.ar_complex(), db),
                     P.calibrated_budget(db)).fitness(0.05)
    last = res.history[-1]["fitness"]
    assert abs(fit - last) <= 1e-5 * max(abs(fit), 1e-12)


@pytest.mark.slow
@pytest.mark.parametrize("key", JAX_CELLS)
def test_explorer_replays_golden_cells(key):
    ref = _GOLD[key]
    gname, aware, s, it = key.split("@")[0].split(".")
    _, res = run_port(GRAPH_FNS[gname], aware, int(s[1:]), int(it[2:]))
    assert seq(res) == ref["seq"], key
    assert res.n_sims == ref["n_sims"], key
