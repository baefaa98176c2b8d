"""``moe_row_use.prefill``: the share of the expert rows the MoE layers
computed over the recorded requests that carry an assignment: 100 times the
program's ``moe/kept`` counter (assignments kept under the static capacity)
over its ``moe/rows`` (E · C a layer call; ``perfbench/spans.py``). Under
the static capacity it sits just under T · k / (E · C), which
``capacity_factor`` sets: it moves only with the capacity or the dispatch
policy, or with the drops."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill" or not run.cfg.n_experts:
        return None
    s = spans.summary(run)
    if s is None:
        return None
    return 100.0 * s["counters"]["moe/kept"] / s["counters"]["moe/rows"]
