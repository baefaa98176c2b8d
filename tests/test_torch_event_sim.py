"""The port's event-driven reference simulator (``core/event_sim.py``, a
framework-free copy) against the JAX package's, field for field, on audio
and ar_complex designs: every float within 1e-5 relative, every name and
count exact."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from _torch_helpers import REL_TOL, chain_designs, to_port  # noqa: E402
from repro.core.event_sim import simulate_events as ref_events  # noqa: E402
from repro_torch.core.event_sim import simulate_events  # noqa: E402


def assert_same(want, got, ctx):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), ctx
        for k in want:
            assert_same(want[k], got[k], (ctx, k))
    elif isinstance(want, float):
        assert abs(want - got) <= REL_TOL * max(abs(want), 1e-12), (ctx, want, got)
    else:
        assert want == got, (ctx, want, got)


@pytest.mark.parametrize("graph,n_noc,max_chunks", [
    ("audio", 1, 64), ("audio", 2, 16), ("ar_complex", 1, 16), ("ar_complex", 3, 8),
])
def test_event_sim_matches_reference(graph, n_noc, max_chunks):
    rg, pg = getattr(R, graph)(), getattr(P, graph)()
    rdb, pdb = R.HardwareDatabase(), P.HardwareDatabase()
    if n_noc == 1:
        designs = [R.Design.base(rg)] + R.random_single_noc_designs(rg, 2, seed=5)
    else:
        designs = chain_designs(rg, n_noc, 2, seed=n_noc)
    for i, d in enumerate(designs):
        want = ref_events(d, rg, rdb, max_chunks=max_chunks)
        got = simulate_events(to_port(d), pg, pdb, max_chunks=max_chunks)
        assert got.n_phases == want.n_phases > 0
        for f in dataclasses.fields(want):
            assert_same(getattr(want, f.name), getattr(got, f.name), (graph, i, f.name))
