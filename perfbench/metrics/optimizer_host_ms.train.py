"""``optimizer_host_ms.train``: the median over the recorded training steps
of the host milliseconds of the program's ``train/optimizer`` span
(``optim.adamw.update``: clip and the ``_foreach`` groups;
``perfbench/spans.py``)."""
from perfbench import spans


def read(run):
    if run.cell.mix["kind"] != "train":
        return None
    return spans.per_root(run, "train/step", "train/optimizer", "host_ms")
