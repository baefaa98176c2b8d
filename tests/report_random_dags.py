"""Print, per output column, how far apart the phase simulators are on the
random task graphs of ``chip_smoke.random_dag`` (T ∈ {40, 64, 100}, seeds
0–2, 16 designs each), on the CPU:

  * the JAX package's jitted ``simulate_batch`` against its eager run
    (``jax.disable_jit()``): the reference's spread against itself;
  * the port's plain version against the eager run and the jitted run;
  * the port's plain version with ``rem_ops − compute·φ`` rounded once (one
    fused multiply-add) against the plain version: the conditioning;
  * the plain version with the jit's three named rewrites against the
    jitted run.

Each number is the worst relative error over the nine graphs. Run from the
repo root (it imports both packages):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/report_random_dags.py
"""
import json

import numpy as np

import repro_torch.core as P
from repro_torch.core import phase_sim_torch as PT
from test_torch_random_dags import FLOAT_KEYS, GRAPHS, RJ, random_dag_rows, ref_graph, rel
from test_torch_traffic_conditioning import plain_variant


def main() -> None:
    import jax

    pairs = ("jit_vs_eager", "plain_vs_eager", "plain_vs_jit", "fma_vs_plain", "rewrites_vs_jit")
    worst = {p: dict.fromkeys(FLOAT_KEYS, 0.0) for p in pairs}
    fma = plain_variant("dr_ops")
    rewrites = plain_variant("comp_t", "dr_ops", "alp")
    for t, seed in GRAPHS:
        g, enc, rows = random_dag_rows(t, seed, P.HardwareDatabase())
        renc = RJ.EncodedWorkload.of(ref_graph(g))
        jit = {k: np.asarray(v) for k, v in jax.jit(lambda r: RJ.simulate_batch(renc, r))(rows).items()}
        with jax.disable_jit():
            eager = {k: np.asarray(v) for k, v in RJ.simulate_batch(renc, rows).items()}
        plain = {k: v.numpy() for k, v in PT.simulate_batch(enc, PT.rows_to(rows, "cpu")).items()}
        got = {"jit_vs_eager": (eager, jit), "plain_vs_eager": (eager, plain),
               "plain_vs_jit": (jit, plain), "fma_vs_plain": (plain, fma(enc, rows)),
               "rewrites_vs_jit": (jit, rewrites(enc, rows))}
        for p, (want, have) in got.items():
            for k in FLOAT_KEYS:
                worst[p][k] = max(worst[p][k], rel(want[k], have[k]))
        traffic = {p: rel(want["traffic_bytes"], have["traffic_bytes"]) for p, (want, have) in got.items()}
        print(json.dumps({"graph": g.name, "traffic_bytes": traffic}), flush=True)
    print(json.dumps({"worst_rel_err_over_graphs": worst}), flush=True)


if __name__ == "__main__":
    main()
