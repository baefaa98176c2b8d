"""``mamba_proj_ms.prefill_hybrid``: the median over the recorded requests of
the device milliseconds of the program's ``mamba/proj`` spans (in_proj, the
conv and SiLU; then the gate, the grouped norm and out_proj: two intervals a
layer), summed over the Mamba-2 layers; CUDA events in the request as it
runs (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid":
        return None
    return spans.per_root(run, "serve/prefill", "mamba/proj", "device_ms")
