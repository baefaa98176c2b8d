"""The CUDA flash-attention kernel on the card, against its plain PyTorch
version, and the serving path through it: one wgmma tile of each product
against a plain matrix product (the shared-memory swizzle and the wgmma
descriptors), both routes over their shapes, strided model-layout inputs,
and one ``ops.flash_attention`` call counted as one kernel. Every test here needs a CUDA
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


def _plain(q, k, v, causal):
    from repro_torch.kernels.flash_attention.ref import attention_reference

    return attention_reference(q, k, v, causal=causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_wgmma_tile_matches_matmul(cuda, dh):
    """S = q kᵀ from shared-memory operands, and bf16(S) v with the A operand
    in registers and v through the transpose bit: exact f32 sums of exact
    bf16 products, so only the summation order differs."""
    from repro_torch.kernels.flash_attention.kernel import wgmma_tile

    g = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = (torch.randn(64, dh, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    s, o = wgmma_tile(q, k, v)
    torch.cuda.synchronize()
    want_s = q.float() @ k.float().T
    torch.testing.assert_close(s, want_s, atol=1e-3, rtol=1e-4)
    want_o = s.to(torch.bfloat16).float() @ v.float()
    torch.testing.assert_close(o, want_o, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 4), (32, 2), (8, 1)], ids=["mha", "gqa2", "gqa16", "mqa"])
@pytest.mark.parametrize("s", [200, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_route_matches_plain_version(cuda, dh, h, kh, s, causal):
    from repro_torch.kernels.flash_attention import kernel as K

    g = torch.Generator(device=cuda).manual_seed(s + dh + h)
    b = 2 if s < 2048 else 1
    q = torch.randn(b, h, s, dh, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, kh, s, dh, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, kh, s, dh, generator=g, device=cuda).to(torch.bfloat16)
    before = dict(K.launches_by_route)
    out = K.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launches_by_route["tensor_cores"] == before["tensor_cores"] + 1
    assert K.launches_by_route["cuda_cores"] == before["cuda_cores"]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), _plain(q, k, v, causal).float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv", [(96, 160), (160, 96), (1, 300), (333, 333)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_route_uneven_sequences(cuda, sq, skv, causal):
    """Sq ≠ Skv (the causal mask top-left aligned, as the reference's) and
    lengths no 64-row tile divides."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    g = torch.Generator(device=cuda).manual_seed(sq * 7 + skv)
    q = torch.randn(2, 6, sq, 128, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, 2, skv, 128, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(2, 2, skv, 128, generator=g, device=cuda).to(torch.bfloat16)
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), _plain(q, k, v, causal).float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 128),
                                      (torch.bfloat16, 32)])
def test_strided_model_layout_reads_in_place(cuda, dtype, dh):
    """q, k and v sliced from one fused (B, S, H + 2 KH, Dh) projection, as
    the model could pass them: the kernel reads them through their strides
    and gives what contiguous copies give, on either route."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ops import flash_attention

    b, s, h, kh = 2, 300, 16, 8
    g = torch.Generator(device=cuda).manual_seed(dh)
    fused = torch.randn(b, s, h + 2 * kh, dh, generator=g, device=cuda).to(dtype)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kh], fused[:, :, h + kh:]
    assert not q.is_contiguous() and K.kernel_reads(q) and K.kernel_reads(v)
    out = flash_attention(q, k, v, causal=True)
    again = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert out.shape == (b, s, h, dh) and out.is_contiguous()
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    want = _plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_ops_call_is_one_kernel_and_no_copy(cuda):
    """One ``ops.flash_attention`` call on the model's (B, S, H, Dh) layout
    launches exactly one kernel on the card: the attention kernel, with no
    copy kernel before or after it; the model's reshape of it is a view."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 256, 16, 128, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, 256, 8, 128, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(2, 256, 8, 128, generator=g, device=cuda).to(torch.bfloat16)
    flash_attention(q, k, v)  # build and load outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "flash_fwd_tc" in kernels[0], kernels
    assert out.reshape(2, 256, -1).data_ptr() == out.data_ptr() and out.is_contiguous()


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q = torch.zeros(1, 4, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 4, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="16-byte"):  # a stride TMA cannot take
        wide = torch.zeros(1, 4, 64, 65, device=cuda)[..., :64]
        flash_attention_cuda(wide, wide, wide)
    for dtype in (torch.float64, torch.float16):  # f32 and bf16 only
        with pytest.raises(TypeError):
            flash_attention_cuda(q.to(dtype), q.to(dtype), q.to(dtype))


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernel(cuda):
    from repro_torch.configs.registry import reduced_config
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import RunFlags, init_params

    cfg = reduced_config("qwen3-1.7b")
    model = init_params(cfg, seed=0, dtype=torch.bfloat16)
    assert model.device.type == "cuda"
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=cuda)
    K.reset_launches()
    out, logits = generate(model, cfg, {"tokens": toks}, 5, flags=RunFlags(attn_impl="kernel"))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == cfg.n_layers  # one per layer, in the prefill
    assert K.launches_by_route[K.route(torch.bfloat16, cfg.head_dim)] == cfg.n_layers
    assert out.shape == (2, 5) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all())
    # one step through the plain attention gives the same logits, at the
    # reference's prefill/decode bar (tests/test_train_serve.py)
    _, plain = generate(model, cfg, {"tokens": toks}, 1, flags=RunFlags(attn_impl="full"))
    _, kernel = generate(model, cfg, {"tokens": toks}, 1, flags=RunFlags(attn_impl="kernel"))
    torch.testing.assert_close(kernel, plain, atol=5e-2, rtol=2e-2)
