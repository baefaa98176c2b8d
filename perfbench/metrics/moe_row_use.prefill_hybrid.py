"""``moe_row_use.prefill_hybrid``: the share of the expert rows the MoE
layers computed over the recorded requests that carry an assignment: 100
times the program's ``moe/kept`` counter over its ``moe/rows`` (E · C a
layer call; ``perfbench/spans.py``), as ``moe_row_use.prefill`` reads it."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid":
        return None
    s = spans.summary(run)
    if s is None:
        return None
    return 100.0 * s["counters"]["moe/kept"] / s["counters"]["moe/rows"]
