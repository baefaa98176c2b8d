"""The sharded step laid out as the reference's partitioner lays it out,
held to the JAX package's own compiled dry run (part 1: the dense and
Mamba stacks; ``tests/test_torch_layout_large.py`` has the rest).

For each arch, the port's ``train_4k × 16x16`` step cut to one layer
cycle at full width runs under the ``fake`` process group at world 256 on
meta tensors (``repro_torch.launch.dryrun``), and
``launch.dryrun.layout_bars`` holds it to the reference's compiled step of
the same cut cell (``tests/data/ref_dryrun_train_4k.json``) and to the
port's numbers before this layout (``tests/data/port_dryrun_before.json``):

- argument bytes equal the reference's (the state is placed as it places it);
- temp bytes at most 2 × the reference's, and no more than before;
- flops at most 2 × ``roofline.analytic.step_costs`` (the reference's own
  step model), and no more than before;
- collective bytes at most max(10 × the model's ICI bytes, before / 4), no
  more than before, and at most 1.5 × those of the layout that first met
  these bars (``tests/data/port_dryrun_after.json``).

Decode, part 1 of the serving steps' layout (part 2, prefill:
``tests/test_torch_layout_prefill.py``): each arch's ``decode_32k`` step
cut to one cycle leaves every weight on its FSDP shard
(``sharding.act.weights_as_placed``) and holds no more temp bytes than
before, sending at most 1.5 × the collective bytes of the layout that
first met the bars above (``tests/_layout.py``'s ``serving_check``).

The fixture is the reference's: the Qwen3-1.7B one-cycle cell is compiled
again here, live, through ``tests/gen_ref_dryrun.py`` in a subprocess with
512 host devices, and its integers equal the file's.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _layout import ARCHS, BARS, LARGE, fixture, layout, serving_check  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bar", BARS)
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in LARGE])
def test_one_cycle_layout_meets_the_reference(arch, bar):
    got = layout(arch)[bar]
    assert got["ok"], (arch, bar, got)


@pytest.mark.parametrize("arch", list(fixture("port_dryrun_before.json")["decode_32k"]))
def test_decode_layout_holds_and_sends_no_more(arch):
    serving_check("decode_32k", arch)


def test_fixture_is_the_reference_compiled_live():
    """Qwen3-1.7B × train_4k × 16x16 at one cycle, compiled now by the JAX
    package on an Auto-axis mesh of 512 host devices: memory and
    collective bytes equal the fixture's, integer for integer."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "gen_ref_dryrun.py"), "--arch", "qwen3-1.7b",
                          "--depth", "one", "--print"], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    live = json.loads(out.stdout.strip().splitlines()[-1])
    want = fixture("ref_dryrun_train_4k.json")["one_cycle"]["qwen3-1.7b"]
    assert live["n_layers"] == want["n_layers"] == 1
    assert live["memory"] == want["memory"]
    assert live["collectives"] == want["collectives"]
