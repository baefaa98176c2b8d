"""The port's architecture configs are the reference's: every registered
config and every reduced config, field by field (the port's own fields at
their defaults), and the derived properties the model code reads."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import registry as R  # noqa: E402
from repro_torch.configs import registry as P  # noqa: E402
from _torch_helpers import assert_same_config  # noqa: E402


def test_same_architectures():
    assert list(P.ARCHS) == list(R.ARCHS)
    assert P.arch_names() == R.arch_names()


@pytest.mark.parametrize("name", list(R.ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_and_derived(name, reduced):
    get = (lambda m: m.reduced_config(name)) if reduced else (lambda m: m.get_config(name))
    ref, port = get(R), get(P)
    assert_same_config(port, ref)  # the port's own fields at their defaults
    assert (port.cycle_len, port.n_cycles, port.ssm_d_inner, port.ssm_n_heads) == (
        ref.cycle_len, ref.n_cycles, ref.ssm_d_inner, ref.ssm_n_heads)
    assert [port.mlp_kind_at(i) for i in range(port.cycle_len)] == [
        ref.mlp_kind_at(i) for i in range(ref.cycle_len)]
    assert (port.has_attention(), port.has_mamba(), port.has_moe()) == (
        ref.has_attention(), ref.has_mamba(), ref.has_moe())
    assert port.param_counts() == ref.param_counts()


def test_shapes_and_applicability():
    from repro.configs import base as RB
    from repro_torch.configs import base as PB

    assert {k: dataclasses.asdict(v) for k, v in PB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}
    for name in R.ARCHS:
        for shape in RB.SHAPES:
            assert PB.shape_applicable(P.get_config(name), PB.SHAPES[shape]) == RB.shape_applicable(
                R.get_config(name), RB.SHAPES[shape])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        P.get_config("no-such-arch")
