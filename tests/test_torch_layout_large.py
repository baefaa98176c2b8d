"""The sharded step's layout against the reference's compiled dry run,
part 2: the large dense stack and the MoE stacks (Mistral-Large, Jamba,
Grok-1, Qwen3-MoE), one layer cycle each at full width. The bars and the
fixtures are part 1's (``tests/test_torch_layout.py``).

Depth: the same four archs (which needed more than a card while gathered
weights or unreduced gradients were kept from layer to layer) cut to one
and to two cycles: the temp bytes the second cycle adds are at most 1.5 ×
the argument bytes it adds, and the full stack extrapolated by that
growth fits 80 GB a device (``launch.dryrun.depth_bars``)."""
import pytest

torch = pytest.importorskip("torch")

from _layout import BARS, LARGE, depth, layout  # noqa: E402


@pytest.mark.parametrize("bar", BARS)
@pytest.mark.parametrize("arch", LARGE)
def test_one_cycle_layout_meets_the_reference(arch, bar):
    got = layout(arch)[bar]
    assert got["ok"], (arch, bar, got)


@pytest.mark.parametrize("bar", ("temp_growth", "full_depth"))
@pytest.mark.parametrize("arch", LARGE)
def test_a_cycle_adds_no_gathered_weights(arch, bar):
    got = depth(arch)[bar]
    assert got["ok"], (arch, bar, got)
