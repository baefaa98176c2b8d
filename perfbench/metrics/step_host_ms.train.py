"""``step_host_ms.train``: the median over the recorded training steps of
the host milliseconds of the program's ``train/step`` span: the step's
enqueue (the driver's synchronise lies outside it; ``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "train":
        return None
    return spans.per_root(run, "train/step", "train/step", "host_ms")
