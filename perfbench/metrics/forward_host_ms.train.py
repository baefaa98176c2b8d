"""``forward_host_ms.train``: the median over the recorded training steps
of the host milliseconds of the program's ``train/forward`` spans (the
forward, the LM head and the chunked CE), summed over a step's
microbatches (``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "train":
        return None
    return spans.per_root(run, "train/step", "train/forward", "host_ms")
