"""``moe_combine_ms.prefill``: the median over the recorded requests of the
device milliseconds of the program's ``moe/combine`` spans (the gate
weight, the gather and the sum over k), summed over the MoE layers; CUDA
events in the request as it runs (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill" or not run.cfg.n_experts:
        return None
    return spans.per_root(run, "serve/prefill", "moe/combine", "device_ms")
