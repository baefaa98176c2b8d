"""``moe_dispatch_ms.prefill``: the median over the recorded requests of the
device milliseconds of the program's ``moe/dispatch`` spans (the position
cumsum through the ``index_add`` into the expert buffer), summed over the
MoE layers; CUDA events in the request as it runs (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill" or not run.cfg.n_experts:
        return None
    return spans.per_root(run, "serve/prefill", "moe/dispatch", "device_ms")
