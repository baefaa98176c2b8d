"""Shared by ``tests/test_torch_layout*.py``: the port's ``16x16`` dry run
of an arch cut to one (or two) layer cycles at full width, held by
``repro_torch.launch.dryrun.layout_bars`` and ``depth_bars`` to the
reference's compiled dry run (``tests/data/ref_dryrun_train_4k.json``,
written by ``tests/gen_ref_dryrun.py``) and to the port's own numbers
before and after its layout followed the reference's
(``tests/data/port_dryrun_{before,after}.json``, written by
``tests/gen_port_dryrun.py``)."""
import functools
import json
import os

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BARS = ("argument_bytes", "temp_bytes", "flops", "collective_bytes")
LARGE = D.DEPTH_ARCHS  # part 2's archs, whose depth growth is held too


def fixture(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


ARCHS = tuple(fixture("ref_dryrun_train_4k.json")["one_cycle"])


@functools.lru_cache(maxsize=None)
def record(arch: str, shape_name: str = "train_4k", cycles: int = 1) -> dict:
    """The dry-run record of the arch cut to ``cycles`` × ``shape_name`` ×
    16x16, run once a process (in-process, under the fake group at world
    256, on a "cuda"-typed mesh of meta tensors, as the dry run's CLI runs
    it)."""
    with D.fake_world(256):
        rec = D.run_cell(D.cut(get_config(arch), cycles), shape_name, False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    return rec


def layout(arch: str) -> dict:
    """``layout_bars`` of the arch's one-cycle train_4k cell."""
    before, after = fixture("port_dryrun_before.json"), fixture("port_dryrun_after.json")
    return D.layout_bars(record(arch), fixture("ref_dryrun_train_4k.json")["one_cycle"][arch],
                         before["train_4k"][arch], after["train_4k"][arch], D.cut(get_config(arch), 1),
                         SHAPES["train_4k"], {"data": 16, "model": 16})


def depth(arch: str) -> dict:
    """``depth_bars`` of the arch's train_4k cell at one and two cycles."""
    return D.depth_bars(record(arch), record(arch, cycles=2), get_config(arch))


def serving_check(shape_name: str, arch: str) -> None:
    """The arch's one-cycle serving cell against the port's own numbers:
    argument bytes equal and temp bytes no more than before the layout
    followed the reference's; collective bytes at most ``AFTER_X`` × those
    of the layout that first met its bars."""
    rec = record(arch, shape_name)
    before = fixture("port_dryrun_before.json")[shape_name][arch]
    after = fixture("port_dryrun_after.json")[shape_name][arch]
    assert rec["memory"]["argument_bytes"] == before["argument_bytes"]
    assert rec["memory"]["temp_bytes"] <= before["temp_bytes"], (rec["memory"], before)
    assert rec["collectives"]["total"] <= D.AFTER_X * after["collective_bytes"], (rec["collectives"], after)
