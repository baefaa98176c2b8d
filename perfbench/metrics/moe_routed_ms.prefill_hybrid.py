"""``moe_routed_ms.prefill_hybrid``: the median over the recorded requests
of the device milliseconds of the program's ``moe/dispatch``,
``moe/experts`` and ``moe/combine`` spans together (the routed experts'
dispatch, products and combine, without the shared expert), summed over the
MoE layers; CUDA events in the request as it runs (``perfbench/spans.py``)."""
import statistics

from perfbench import spans

PARTS = ("moe/dispatch", "moe/experts", "moe/combine")


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid":
        return None
    s = spans.summary(run)
    if s is None:
        return None
    units = [r["spans"] for r in s["roots"] if r["name"] == "serve/prefill"]
    lacking = sum(any(p not in u for p in PARTS) for u in units)
    if not units or lacking:
        raise LookupError(f"{lacking} of {len(units)} recorded serve/prefill spans lack one of {PARTS}")
    values = [[u[p]["device_ms"] for p in PARTS] for u in units]
    if any(None in v for v in values):
        return None
    return statistics.median(sum(v) for v in values)
