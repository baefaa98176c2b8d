"""The CUDA SSD chunk-scan kernel on the card, against its plain PyTorch
version (``ref.ssd_reference``) and the token-by-token recurrence, and the
Mamba-2 serving path through it. Every test here needs a CUDA device: each
carries the ``gpu`` marker and skips where there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_ssd.py
"""
import pytest

torch = pytest.importorskip("torch")

# the reference's bars (tests/test_kernels.py): y 5e-2 in bf16 and 1e-3 in
# f32, the final state 1e-3
Y_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
H_TOL = 1e-3
CASES = [  # (B, S, H, P, N, chunk, dtype): test_kernels.SSD_CASES, then the serving shape
    (2, 128, 4, 16, 8, 32, torch.float32),
    (1, 256, 2, 64, 128, 128, torch.float32),
    (2, 64, 8, 32, 16, 16, torch.float32),
    (1, 128, 4, 64, 32, 64, torch.bfloat16),
    (4, 512, 32, 64, 128, 64, torch.bfloat16),
    (1, 96, 2, 64, 128, 96, torch.float32),  # a chunk that is no power of two
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(b, s, h, p, n, dtype, device, seed=0, bc_dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g, device=device))
    a = -torch.exp(torch.randn(h, generator=g, device=device))
    bm = torch.randn(b, s, n, generator=g, device=device).to(bc_dtype)
    cm = torch.randn(b, s, n, generator=g, device=device).to(bc_dtype)
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda, case):
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import ssd_reference

    b, s, h, p, n, chunk, dtype = case
    x, dt, a, bm, cm = inputs(b, s, h, p, n, dtype, cuda, seed=s + p)
    before = ssd_cuda.launches
    y, h_final = ssd_cuda(x, dt, a, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    y_ref, h_ref = ssd_reference(x, dt, a, bm, cm, chunk=chunk)
    assert y.dtype == dtype and y.shape == x.shape and h_final.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=Y_TOL[dtype], rtol=Y_TOL[dtype])
    torch.testing.assert_close(h_final, h_ref, atol=H_TOL, rtol=H_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [8, 32, 64, 128])
def test_kernel_matches_recurrence_at_every_chunk(cuda, chunk):
    """bf16 B and C, as the model passes them (slices of one bf16 projection)."""
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import ssd_naive

    x, dt, a, bm, cm = inputs(2, 128, 4, 64, 128, torch.bfloat16, cuda, seed=chunk,
                              bc_dtype=torch.bfloat16)
    y, h_final = ssd_cuda(x, dt, a, bm, cm, chunk)
    y_ref, h_ref = ssd_naive(x, dt, a, bm, cm)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h_final, h_ref, atol=H_TOL, rtol=H_TOL)


@pytest.mark.gpu
def test_cuda_calls_raise_and_never_fall_back(cuda):
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ops import ssd

    x, dt, a, bm, cm = inputs(1, 256, 2, 64, 16, torch.float32, cuda)
    before = ssd_cuda.launches
    with pytest.raises(TypeError):  # the plain version would take float16
        ssd(x.half(), dt, a, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="chunk"):  # the plain version would take 256
        ssd(x, dt, a, bm, cm, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(2, 3), dt, a, bm, cm, 64)
    assert ssd_cuda.launches == before
    y, _ = ssd(x[:, :, :, :32], dt, a, bm, cm, chunk=64)  # strided views are made contiguous
    assert ssd_cuda.launches == before + 1 and y.shape == (1, 256, 2, 32)


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernels(cuda):
    """Reduced mamba2-370m served through both kernels: one SSD launch per
    layer in the prefill, and per call (prefill and each decode step) one
    RMSNorm launch per layer's norm1 and gated norm plus the final norm."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import RunFlags, init_params

    cfg = reduced_config("mamba2-370m")
    model = init_params(cfg, seed=0, dtype=torch.bfloat16)
    assert model.device.type == "cuda"
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=cuda)
    kernel = RunFlags(ssd_impl="kernel", norm_impl="kernel")
    ssd_cuda.launches = rmsnorm_cuda.launches = 0
    out, logits = generate(model, cfg, {"tokens": toks}, 5, flags=kernel)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == cfg.n_layers
    assert rmsnorm_cuda.launches == (2 * cfg.n_layers + 1) * (1 + 5)
    assert out.shape == (2, 5) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all())
    # the plain path on the same weights, at the reference's prefill/decode
    # bar (tests/test_train_serve.py)
    _, plain = generate(model, cfg, {"tokens": toks}, 1, flags=RunFlags())
    _, through = generate(model, cfg, {"tokens": toks}, 1, flags=kernel)
    torch.testing.assert_close(through, plain, atol=5e-2, rtol=2e-2)
