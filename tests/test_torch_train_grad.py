"""The port's training gradients through attention, RMSNorm and the SSD,
against the JAX package on the CPU.

``models.flash_ref._bwd_impl`` is held to the reference's ``_bwd_impl`` on
the same (q, k, v, out, lse, dout), and ``FlashAttentionRef`` to
``jax.vjp`` of the reference's ``custom_vjp``: f32, each output within
1e-5 of its own max |value| (both run the same f32 blockwise arithmetic in
another summation order; measured worst about 5e-7). The kernel wrappers'
``torch.autograd.Function``s run their plain versions on CPU tensors: flash
is held to autograd of ``layers.attention_full`` and RMSNorm to autograd of
``layers.rms_norm`` at the same 1e-5. Under autograd no kernel op returns a
tensor without a ``grad_fn``: flash and RMSNorm go through their
Functions, and the SSD kernel, which has no backward, raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import flash_ref as RF  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.models import flash_ref as PF  # noqa: E402
from repro_torch.models.layers import attention_full, rms_norm  # noqa: E402
from repro_torch.models.model import RunFlags, forward_hidden, init_params  # noqa: E402

TOL = 1e-5  # each output's max |difference| over its own max |value|
B, S, H, DH = 2, 32, 4, 16


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def inputs(kh, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, DH), (B, S, kh, DH), (B, S, kh, DH), (B, S, H, DH)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


CASES = [(kh, qb, kb, causal) for kh in (4, 2, 1) for qb, kb in ((8, 16), (16, 8), (32, 32))
         for causal in (True, False)]


@pytest.mark.parametrize("kh,q_block,kv_block,causal", CASES)
def test_bwd_impl_matches_reference(kh, q_block, kv_block, causal):
    q, k, v, do = inputs(kh)
    out, lse = RF._fwd_impl(*map(jnp.asarray, (q, k, v)), causal, q_block, kv_block)
    want = RF._bwd_impl(*map(jnp.asarray, (q, k, v)), out, lse, jnp.asarray(do), causal, q_block, kv_block)
    got = PF._bwd_impl(*map(torch.from_numpy, (q, k, v, np.array(out), np.array(lse), do)),
                       causal, q_block, kv_block)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert rel(g.numpy(), w) <= TOL, (name, rel(g.numpy(), w))


@pytest.mark.parametrize("kh,q_block,kv_block", [(2, 8, 16), (1, 16, 8), (4, 32, 32)])
def test_flash_ref_function_matches_reference_vjp(kh, q_block, kv_block):
    """The Function end to end (forward saving (q, k, v, out, lse), the
    flash backward) against ``jax.vjp`` of the reference's custom VJP."""
    q, k, v, do = inputs(kh, seed=1)
    out, vjp = jax.vjp(lambda a, b_, c: RF.flash_attention_ref(a, b_, c, True, q_block, kv_block),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got_out = PF.flash_attention_ref(*xs, True, q_block, kv_block)
    assert "FlashAttentionRef" in type(got_out.grad_fn).__name__
    got = torch.autograd.grad(got_out, xs, torch.from_numpy(do))
    assert rel(got_out.detach().numpy(), out) <= TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel(g.numpy(), w) <= TOL, name


@pytest.mark.parametrize("kh", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ops_function_matches_autograd_of_attention_full(kh, causal):
    q, k, v, do = inputs(kh, seed=3)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ys = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = flash_attention(*xs, causal, 8, 16)
    assert got.grad_fn is not None and "FlashAttention" in type(got.grad_fn).__name__
    want = attention_full(*ys, causal=causal)
    assert rel(got.detach().numpy(), want.detach().numpy()) <= TOL
    g = torch.autograd.grad(got, xs, torch.from_numpy(do))
    w = torch.autograd.grad(want, ys, torch.from_numpy(do))
    for name, a, c in zip(("dq", "dk", "dv"), g, w):
        assert rel(a.numpy(), c.numpy()) <= TOL, name


def test_flash_ops_without_grad_saves_nothing():
    """No input needs a gradient: the call is the serving call (no Function,
    no lse, no graph)."""
    q, k, v, _ = inputs(2, seed=4)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), True, 8, 16)
    assert out.grad_fn is None and not out.requires_grad
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert flash_attention(*xs, True, 8, 16).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(*xs, True, 8, 16).grad_fn is None


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 16), (2, 4, 3, 16)])
@pytest.mark.parametrize("grad_w", [True, False])
def test_rmsnorm_function_matches_autograd_of_rms_norm(shape, grad_w):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    xs = [torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_(grad_w)]
    ys = [torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_(grad_w)]
    got = rmsnorm(*xs)
    assert got.grad_fn is not None and "RMSNorm" in type(got.grad_fn).__name__
    want = rms_norm(*ys)
    assert torch.equal(got.detach(), want.detach())  # the same plain version on the CPU
    wrt = 2 if grad_w else 1
    g = torch.autograd.grad(got, xs[:wrt], torch.from_numpy(dy))
    w_ = torch.autograd.grad(want, ys[:wrt], torch.from_numpy(dy))
    for a, c in zip(g, w_):
        assert rel(a.numpy(), c.numpy()) <= TOL


def test_rmsnorm_function_bf16_gradients_keep_the_input_dtypes():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.zeros(32, dtype=torch.bfloat16)
    xs = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    ys = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    dy = torch.ones(4, 32, dtype=torch.bfloat16)
    g = torch.autograd.grad(rmsnorm(*xs), xs, dy)
    w_ = torch.autograd.grad(rms_norm(*ys), ys, dy)
    assert [t.dtype for t in g] == [torch.bfloat16, torch.bfloat16]
    for a, c in zip(g, w_):  # both in f32 with one final bf16 rounding
        torch.testing.assert_close(a.float(), c.float(), atol=1e-2, rtol=1e-2)


def ssd_args(requires_grad):
    rng = np.random.default_rng(7)
    b, s, h, p, n = 1, 16, 2, 8, 4
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in
            [(b, s, h, p), (b, s, h), (h,), (b, s, n), (b, s, n)]]
    arrs[1], arrs[2] = np.abs(arrs[1]) * 0.1, -np.abs(arrs[2])
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrs]


def test_ssd_under_grad_raises_and_names_the_roadmap_item():
    args = ssd_args(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd(*args, chunk=8)
    with torch.no_grad():  # no gradient asked for: the plain version runs
        y, h = ssd(*args, chunk=8)
    assert y.grad_fn is None and h.shape == (1, 2, 8, 4)
    y, _ = ssd(*ssd_args(False), chunk=8)  # grad mode, but nothing needs a gradient
    assert y.grad_fn is None


def test_mamba_trains_through_the_reference_ssd_and_not_the_kernel():
    """``ssd_impl="reference"`` trains through plain autograd, as the
    reference trains; ``ssd_impl="kernel"`` raises rather than cut the
    gradient."""
    cfg = reduced_config("mamba2-370m")
    model = init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))}
    hidden, _ = forward_hidden(model, cfg, batch, RunFlags(ssd_chunk=8), compute_dtype=torch.float32)
    grads = torch.autograd.grad(hidden.square().mean(), list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward_hidden(model, cfg, batch, RunFlags(ssd_chunk=8, ssd_impl="kernel"))


@pytest.mark.parametrize("attn_impl,norm_impl", [("kernel", "kernel"), ("blockwise", "reference"),
                                                 ("full", "reference")])
def test_forward_hidden_under_grad_keeps_the_graph(attn_impl, norm_impl):
    """Every attention and norm implementation leaves the hidden state
    attached to the parameters: each parameter gets a nonzero gradient."""
    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    model = init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))}
    flags = RunFlags(attn_impl=attn_impl, norm_impl=norm_impl, q_block=8, kv_block=8)
    hidden, _ = forward_hidden(model, cfg, batch, flags)
    assert hidden.grad_fn is not None
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(hidden.float().square().mean(), params)
    zero = [n for n, g in zip(names, grads) if not g.abs().sum() > 0]
    assert zero == [], zero
