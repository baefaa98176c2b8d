"""The position-in-expert kernel (``kernels.moe_positions``) on the card:
bit for bit the plain version (the one-hot cumsum) at the tile edges and
past them, on ids drawn uniform, all on one expert, sorted and reversed; one
launch counted a call; the wrapper's refusals; and ``moe_apply`` with the
kernel bit for bit ``moe_apply`` with the plain version, at the benchmark's
prefill shape on the reduced Qwen3-MoE config. Every test here needs a CUDA
device: each carries the ``gpu`` marker and skips where there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_moe_positions.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_positions import kernel as PK  # noqa: E402
from repro_torch.kernels.moe_positions import moe_positions, positions_reference  # noqa: E402

# the tile's edges (1,024 ids a block), a warp's (32), the benchmark's
# prefill (4,096 tokens × top 8) and 1,024 tiles
SIZES = [1, 31, 32, 33, 1023, 1024, 1025, 32768, 1048576]
EXPERTS = [1, 3, 8, 16, 128, PK.MAX_EXPERTS]
PATTERNS = ["uniform", "one_expert", "sorted", "reversed"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def ids(n, e, pattern, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed + 7919 * n + e)
    flat = torch.randint(0, e, (n,), generator=g, device=device)
    if pattern == "one_expert":
        return torch.full((n,), e - 1, dtype=torch.long, device=device)
    if pattern == "sorted":
        return flat.sort().values
    if pattern == "reversed":
        return flat.sort(descending=True).values
    return flat


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("e", EXPERTS)
@pytest.mark.parametrize("n", SIZES)
def test_kernel_equals_the_one_hot_cumsum(cuda, n, e, pattern):
    flat = ids(n, e, pattern, cuda)
    got = moe_positions(flat, e)
    want = positions_reference(flat, e)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (n,) and got.is_cuda
    assert torch.equal(got, want)
    if pattern == "one_expert":
        assert torch.equal(got, torch.arange(n, device=cuda))


@pytest.mark.gpu
def test_ids_outside_the_experts_get_zero_as_in_the_one_hot(cuda):
    flat = ids(5000, 16, "uniform", cuda)
    flat[::7] = -3
    flat[3::11] = 16
    got = moe_positions(flat, 16)
    assert torch.equal(got, positions_reference(flat, 16))


@pytest.mark.gpu
def test_each_call_counts_one_launch(cuda):
    PK.moe_positions_cuda.launches = 0
    for n in (8, 32768, 0):
        moe_positions(ids(n, 128, "uniform", cuda), 128)
    torch.cuda.synchronize()
    assert PK.moe_positions_cuda.launches == 2  # the empty call launches nothing


@pytest.mark.gpu
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.dryrun import fake_world

    flat = ids(64, 8, "uniform", cuda)
    with pytest.raises(TypeError):
        moe_positions(flat.to(torch.int32), 8)
    with pytest.raises(ValueError):
        moe_positions(flat[::2], 8)
    with pytest.raises(ValueError):
        moe_positions(flat.reshape(8, 8), 8)
    with pytest.raises(ValueError):
        moe_positions(flat, PK.MAX_EXPERTS + 1)
    with pytest.raises(ValueError):
        moe_positions(flat, 0)
    with fake_world(1):
        mesh = init_device_mesh("cuda", (1,))
        with pytest.raises(TypeError):
            moe_positions(DTensor.from_local(flat, mesh, [Replicate()], run_check=False), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_moe_apply_with_the_kernel_is_bit_for_bit_the_plain_path(cuda, monkeypatch, capacity_factor):
    """The reduced Qwen3-MoE config at the benchmark's prefill shape (B 1 ×
    S 4,096, so N = 4,096 · k spans several tiles) in bf16: ``keep``, y and
    the aux loss identical whether ``positions`` runs the kernel or the one-hot
    cumsum. At the config's capacity factor (1.25) near-balanced routing
    drops nothing; at 1.0 the fuller experts drop."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import moe
    from repro_torch.models.model import init_params

    cfg = reduced_config("qwen3-moe-235b-a22b")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    tree = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda).tree()
    mlp = next(lay["mlp"] for lay in tree["layers"] if "router" in lay.get("mlp", {}))
    x = torch.randn(1, 4096, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(torch.bfloat16)
    PK.moe_positions_cuda.launches = 0
    with torch.inference_mode(), moe.record_routing() as calls:
        y, aux = moe.moe_apply(mlp, x, cfg)
    assert PK.moe_positions_cuda.launches == 1
    monkeypatch.setattr(moe, "moe_positions", positions_reference)
    with torch.inference_mode(), moe.record_routing() as plain:
        want_y, want_aux = moe.moe_apply(mlp, x, cfg)
    assert PK.moe_positions_cuda.launches == 1
    if capacity_factor is not None:
        assert not calls[0]["keep"].all()  # capacity drops take part
    assert torch.equal(calls[0]["keep"], plain[0]["keep"])
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)
