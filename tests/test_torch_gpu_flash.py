"""The CUDA flash-attention kernel on the card, against its plain PyTorch
version, and the serving path through it. Every test here needs a CUDA
device: each carries the ``gpu`` marker and skips where there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_flash.py
"""
import pytest

torch = pytest.importorskip("torch")

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # the reference's bars (test_kernels.py)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 8, 4, 256, 256, 64),   # GQA
    (1, 4, 4, 200, 200, 128),  # MHA, ragged edge (200 is no multiple of the 64-row tile)
    (2, 16, 1, 128, 128, 32),  # MQA
    (1, 4, 2, 96, 160, 256),   # Sq != Skv, Gemma head_dim
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_version(cuda, shape, dtype, causal):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_reference

    b, h, kh, sq, skv, dh = shape
    g = torch.Generator(device=cuda).manual_seed(sq + dh)
    q = torch.randn(b, h, sq, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, kh, skv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, kh, skv, dh, generator=g, device=cuda).to(dtype)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q = torch.zeros(1, 4, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 4, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), q, q)
    for dtype in (torch.float64, torch.float16):  # f32 and bf16 only
        with pytest.raises(TypeError):
            flash_attention_cuda(q.to(dtype), q.to(dtype), q.to(dtype))


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernel(cuda):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import RunFlags, init_params

    cfg = reduced_config("qwen3-1.7b")
    model = init_params(cfg, seed=0, dtype=torch.bfloat16)
    assert model.device.type == "cuda"
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=cuda)
    flash_attention_cuda.launches = 0
    out, logits = generate(model, cfg, {"tokens": toks}, 5, flags=RunFlags(attn_impl="kernel"))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == cfg.n_layers  # one per layer, in the prefill
    assert out.shape == (2, 5) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all())
    # one step through the plain attention gives the same logits, at the
    # reference's prefill/decode bar (tests/test_train_serve.py)
    _, plain = generate(model, cfg, {"tokens": toks}, 1, flags=RunFlags(attn_impl="full"))
    _, kernel = generate(model, cfg, {"tokens": toks}, 1, flags=RunFlags(attn_impl="kernel"))
    torch.testing.assert_close(kernel, plain, atol=5e-2, rtol=2e-2)
