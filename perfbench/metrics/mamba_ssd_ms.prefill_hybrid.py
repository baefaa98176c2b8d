"""``mamba_ssd_ms.prefill_hybrid``: the median over the recorded requests of
the device milliseconds of the program's ``mamba/ssd`` spans (the SSD
chunk-scan call), summed over the Mamba-2 layers; CUDA events in the request
as it runs (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "prefill_hybrid":
        return None
    return spans.per_root(run, "serve/prefill", "mamba/ssd", "device_ms")
