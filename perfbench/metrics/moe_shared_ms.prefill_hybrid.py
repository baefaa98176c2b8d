"""``moe_shared_ms.prefill_hybrid``: the median over the recorded requests of
the device milliseconds of the program's ``moe/shared`` spans (the shared
expert's two products), summed over the MoE layers; CUDA events in the
request as it runs (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid":
        return None
    return spans.per_root(run, "serve/prefill", "moe/shared", "device_ms")
