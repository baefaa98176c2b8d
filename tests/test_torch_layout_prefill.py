"""The serving steps' layout on the production mesh, part 2: each arch's
``prefill_32k`` step cut to one layer cycle at full width, dry-run on
``16x16`` (``repro_torch.launch.dryrun`` under the fake group at world 256,
meta tensors), held by ``tests/_layout.py``'s ``serving_check`` (part 1,
decode: ``tests/test_torch_layout.py``). Serving takes no gradient, so it
leaves every weight on its FSDP shard (``sharding.act.weights_as_placed``);
a serving step that gathered its weights at each use, as the train step
does, would hold and send far more. Against the port's own numbers
(``tests/gen_port_dryrun.py``):

- argument bytes equal those before the sharded step followed the
  reference's layout (``tests/data/port_dryrun_before.json``);
- temp bytes no more than before;
- collective bytes at most 1.5 × those of the layout that first met the
  reference's bars (``tests/data/port_dryrun_after.json``).
"""
import pytest

torch = pytest.importorskip("torch")

from _layout import fixture, serving_check  # noqa: E402


@pytest.mark.parametrize("arch", list(fixture("port_dryrun_before.json")["prefill_32k"]))
def test_prefill_layout_holds_and_sends_no_more(arch):
    serving_check("prefill_32k", arch)
