"""The training path on the card: the flash kernel's row log-sum-exp, the
flash and RMSNorm ``torch.autograd.Function``s against their plain
counterparts, the SSD kernel refusing autograd, and a reduced train step on
the kernel path against the plain path. Every test here needs a CUDA
device: each carries the ``gpu`` marker and skips where there is none.

Bars: out at the reference's forward bars (2e-2 bf16, 2e-5 f32, elementwise
atol + rtol); lse within 1e-5 of its max |value| (both take it in f32 from
the same scores); dq, dk, dv within the forward bar of their own max
|value| (the backward is the same plain ``_bwd_impl`` on both sides, fed
the kernel's or the plain forward's out and lse).

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_train.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # the reference's forward bars (test_kernels.py)
LSE_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


def model_layout(b, s, h, kh, dh, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, s, n, dh, generator=g, device=device).to(dtype) for n in (h, kh, kh, h)]


SHAPES = [  # (b, s, h, kh, dh, dtype): both routes, GQA/MQA/MHA, a ragged S
    (2, 512, 16, 8, 128, torch.bfloat16), (1, 1000, 16, 8, 128, torch.bfloat16),
    (1, 256, 8, 1, 64, torch.bfloat16), (2, 512, 8, 4, 64, torch.float32),
    (2, 256, 4, 2, 32, torch.bfloat16), (1, 192, 4, 4, 16, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_function_matches_the_plain_function(cuda, shape):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.flash_ref import FlashAttentionRef

    b, s, h, kh, dh, dtype = shape
    q, k, v, dout = model_layout(b, s, h, kh, dh, dtype, s, cuda)
    blk = 512 if s % 512 == 0 else s
    xs, ys = ([x.clone().requires_grad_() for x in (q, k, v)] for _ in range(2))
    before = dict(FK.launches_by_route)
    out = flash_attention(*xs, True, blk, blk)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    took = [r for r in FK.ROUTES if FK.launches_by_route[r] != before[r]]
    assert took == [FK.route(dtype, dh)] and sum(FK.launches_by_route.values()) == sum(before.values()) + 1
    grads = torch.autograd.grad(out, xs, dout)
    want = FlashAttentionRef.apply(*ys, True, blk, blk)
    want_grads = torch.autograd.grad(want, ys, dout)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        assert g.dtype == dtype and rel(g, w) <= tol, (name, rel(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_lse_matches_the_plain_forward(cuda, shape):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models.flash_ref import _fwd_impl

    b, s, h, kh, dh, dtype = shape
    q, k, v, _ = model_layout(b, s, h, kh, dh, dtype, s + 1, cuda)
    lse = torch.full((b, s, h), float("nan"), device=cuda)
    out = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), causal=True, lse=lse)
    plain = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), causal=True)
    want_out, want_lse = _fwd_impl(q, k, v, True, s, s)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)  # the lse write changes nothing else
    assert torch.isfinite(lse).all() and rel(lse.view_as(want_lse), want_lse) <= LSE_TOL
    torch.testing.assert_close(out.transpose(1, 2).float(), want_out.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_a_malformed_lse(cuda):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q, k, v, _ = model_layout(1, 128, 4, 2, 64, torch.bfloat16, 0, cuda)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for bad in (torch.empty(1, 128, 4, device=cuda, dtype=torch.bfloat16), torch.empty(1, 4, 128, device=cuda),
                torch.empty(1, 128, 4)):
        with pytest.raises(ValueError, match="lse"):
            flash_attention_cuda(qt, kt, vt, causal=True, lse=bad)


@pytest.mark.gpu
def test_flash_without_grad_is_the_serving_call(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v, _ = model_layout(2, 256, 8, 4, 128, torch.bfloat16, 3, cuda)
    xs = [x.requires_grad_() for x in (q, k, v)]
    with torch.inference_mode():
        out = flash_attention(*xs, True)
    assert out.grad_fn is None
    with torch.no_grad():
        assert flash_attention(*xs, True).grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 2048), (4, 2048, 8, 128), (7, 1001)])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                           (torch.bfloat16, torch.float32)])
def test_rmsnorm_function_gradient(cuda, shape, dtype, w_dtype):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.models.layers import rms_norm

    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=cuda) * 0.1).to(w_dtype)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    xs, ys = ([x.clone().requires_grad_(), w.clone().requires_grad_()] for _ in range(2))
    before = rmsnorm_cuda.launches
    out = rmsnorm(*xs)
    assert rmsnorm_cuda.launches == before + 1 and type(out.grad_fn).__name__ == "RMSNormBackward"
    got = torch.autograd.grad(out, xs, dy)
    want = torch.autograd.grad(rms_norm(*ys), ys, dy)
    torch.cuda.synchronize()
    tol = TOL[dtype] if dtype == torch.bfloat16 else 1e-5
    for name, a, c in zip(("dx", "dw"), got, want):
        assert a.dtype == c.dtype and rel(a, c) <= tol, (name, rel(a, c))


@pytest.mark.gpu
def test_ssd_kernel_refuses_autograd(cuda):
    from repro_torch.kernels.ssd.ops import ssd

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 128, 2, 64, generator=g, device=cuda, requires_grad=True)
    dt = torch.rand(1, 128, 2, generator=g, device=cuda) * 0.1
    a = -torch.rand(2, generator=g, device=cuda)
    bm, cm = (torch.randn(1, 128, 64, generator=g, device=cuda) for _ in range(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd(x, dt, a, bm, cm, chunk=64)


@pytest.mark.gpu
@pytest.mark.parametrize("microbatches", [1, 2])
def test_reduced_train_step_kernel_path_matches_plain_path(cuda, microbatches):
    """One step from one state and batch: the kernel path (flash and RMSNorm
    kernels under autograd, remat) against the plain path; loss within 2e-2
    relative, grad norm within 5e-2, every parameter within 2.5 lr, and the
    launches the step's structure fixes."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.models.model import RunFlags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=3)
    batch = for_model(cfg, seq_len=128, global_batch=4, seed=0).next_batch()
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    kernel = RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full")
    plain = RunFlags(attn_impl="blockwise", norm_impl="reference", remat="full", q_block=64, kv_block=64)
    FK.reset_launches()
    rmsnorm_cuda.launches = 0
    ks, km = make_train_step(cfg, kernel, opt, microbatches)(init_train_state(cfg, seed=0), batch)
    torch.cuda.synchronize()
    assert FK.flash_attention_cuda.launches == cfg.n_layers * 2 * microbatches
    assert rmsnorm_cuda.launches == (cfg.n_layers * 4 * 2 + 1) * microbatches
    ps, pm = make_train_step(cfg, plain, opt, microbatches)(init_train_state(cfg, seed=0), batch)
    assert ks["params"].device.type == "cuda"
    assert abs(km["loss"].item() - pm["loss"].item()) <= 2e-2 * abs(pm["loss"].item())
    assert abs(km["grad_norm"].item() - pm["grad_norm"].item()) <= 5e-2 * pm["grad_norm"].item()
    for (n, a), (_, c) in zip(ks["params"].named_parameters(), ps["params"].named_parameters()):
        assert (a - c).abs().max().item() <= 2.5 * km["lr"].item(), n
