"""The MoE layer and the MoE serving path on the card: ``moe_apply`` routes
as on the CPU and runs without a host synchronisation, reduced Jamba's
kernel path agrees with its plain path, and one reduced ``generate`` makes
the kernel launches the stack implies. Every test here needs a CUDA device:
each carries the ``gpu`` marker and skips where there is none.

Bars: ``moe_apply`` in f32 (TF32 off) with the CPU's routing (``expert_idx``
and ``keep`` identical), y and the aux loss within 1e-5; reduced Jamba in
f32, kernel path (flash, SSD and RMSNorm kernels on their CUDA-core routes:
head dim 16, P = N = 16) against the plain path with identical routing in
every MoE layer, logits at the reference's serving bar (atol 5e-2, rtol
2e-2). In bf16 at d_model 64 the two paths' rounding alone reaches that bar;
``chip_smoke.py`` ``serve_moe`` holds bf16 at full width.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_moe.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

TOL = 1e-5
ATOL, RTOL = 5e-2, 2e-2
MOE = ["jamba-v0.1-52b", "qwen3-moe-235b-a22b", "grok-1-314b"]
B, S = 2, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain paths in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def layer(name, capacity_factor, seed):
    """A reduced config's MoE weights (``init_params``' draw, layer 1 or 0)
    and seeded f32 tokens, on the CPU."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(reduced_config(name), capacity_factor=capacity_factor)
    tree = init_params(cfg, seed=seed, device="cpu").tree()
    mlp = next(lay["mlp"] for lay in tree["layers"] if "router" in lay.get("mlp", {}))
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(seed))
    return cfg, mlp, x


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_on_card_matches_cpu(cuda, name, capacity_factor):
    from repro_torch.models.moe import moe_apply, record_routing

    cfg, mlp, x = layer(name, capacity_factor, MOE.index(name))
    with record_routing() as cpu:
        want_y, want_aux = moe_apply(mlp, x, cfg)
    dev = {k: v.to(cuda) for k, v in mlp.items()}
    with record_routing() as card:
        y, aux = moe_apply(dev, x.to(cuda), cfg)
    assert torch.equal(card[0]["expert_idx"].cpu(), cpu[0]["expert_idx"])
    assert torch.equal(card[0]["keep"].cpu(), cpu[0]["keep"])
    if capacity_factor < 1:
        assert not cpu[0]["keep"].all()  # capacity drops take part
    torch.testing.assert_close(y.cpu(), want_y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_makes_no_host_sync(cuda, dtype):
    from repro_torch.models.moe import moe_apply

    cfg, mlp, x = layer("jamba-v0.1-52b", 1.25, 0)
    dev = {k: (v if k == "router" else v.to(dtype)).to(cuda) for k, v in mlp.items()}
    x = x.to(cuda, dtype)
    with torch.inference_mode():
        moe_apply(dev, x, cfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_apply(dev, x, cfg)
            moe_apply(dev, x[:, :1], cfg)  # the decode shape
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(y).all() and torch.isfinite(aux)


@pytest.mark.gpu
def test_reduced_jamba_kernel_path_matches_plain_path(cuda):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.model import RunFlags, forward, init_params
    from repro_torch.models.moe import record_routing

    cfg = reduced_config("jamba-v0.1-52b")
    model = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(cuda)}
    kernel = RunFlags(attn_impl="kernel", ssd_impl="kernel", norm_impl="kernel")
    with torch.inference_mode():
        with record_routing() as rk:
            got, aux_k, _ = forward(model, cfg, batch, kernel, torch.float32)
        with record_routing() as rp:
            want, aux_p, _ = forward(model, cfg, batch, RunFlags(), torch.float32)
    assert len(rk) == len(rp) == 4
    for a, b in zip(rk, rp):
        assert torch.equal(a["expert_idx"], b["expert_idx"]) and torch.equal(a["keep"], b["keep"])
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(aux_k, aux_p, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen3-moe-235b-a22b"])
def test_reduced_generate_launch_counts(cuda, name):
    """One generate of 4 new tokens: a flash per attention layer and an SSD
    per Mamba-2 layer in the prefill, and (norm1 + norm2 per layer, q- and
    k-norm per qk-norm attention layer, the gated norm per Mamba-2 layer,
    the final norm) RMSNorms and a position-in-expert call per MoE layer in
    each of the 5 calls, as ``chip_smoke.moe_want_launches`` counts them."""
    import sys
    from pathlib import Path

    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_positions import kernel as PK
    from repro_torch.kernels.rmsnorm import kernel as NK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import RunFlags, init_params

    cfg = reduced_config(name)
    model = init_params(cfg, seed=0, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (4, S), generator=torch.Generator().manual_seed(2))
    flags = RunFlags(attn_impl="kernel", ssd_impl="kernel", norm_impl="kernel")
    FK.reset_launches()
    SK.reset_launches()
    NK.rmsnorm_cuda.launches = 0
    PK.moe_positions_cuda.launches = 0
    out, last = generate(model, cfg, {"tokens": tokens.to(cuda)}, 4, flags=flags)
    torch.cuda.synchronize()
    attn = cfg.block_kinds.count("attn") * cfg.n_layers // cfg.cycle_len
    mamba = cfg.n_layers - attn
    per_call = 2 * cfg.n_layers + mamba + (2 * attn if cfg.qk_norm else 0) + 1
    assert FK.flash_attention_cuda.launches == attn
    assert SK.ssd_cuda.launches == mamba
    assert NK.rmsnorm_cuda.launches == 5 * per_call
    moe_layers = sum(cfg.mlp_kind_at(i % cfg.cycle_len) == "moe" for i in range(cfg.n_layers))
    assert moe_layers > 0 and PK.moe_positions_cuda.launches == 5 * moe_layers
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    assert CS.moe_want_launches(cfg, 5)["moe_positions"] == PK.moe_positions_cuda.launches
    assert out.shape == (4, 4) and torch.isfinite(last).all()
