"""The port's decoder layers against the reference's, on the same numpy
inputs: norms, rotary embeddings, the three attention forms, the MLPs and
the blockwise flash forward (output and log-sum-exp).

Bars: 1e-5 (absolute and relative) in f32, where the two packages differ
only in summation order. In bf16 both round at the same points, so a value
lands at most one bf16 ulp apart where a product accumulated in another
order rounds the other way: the bar is 2^-8 (one bf16 ulp at 1.0) absolute
and relative, a fifth of the reference's bf16 bar for attention (2e-2,
``tests/test_kernels.py``). Measured on these inputs: attention_full differs
by about 1e-3 at most, every other layer not at all."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import flash_ref as RF  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.models import flash_ref as PF  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def pair(a: np.ndarray, dt: str):
    """The same values in both packages, rounded to the dtype alike."""
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.array(a)).to(tdt)


def close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = pair(randn(rng, 2, 5, 48), dt), pair(randn(rng, 48, scale=0.1), dt)
    out = PL.rms_norm(xt, wt, 1e-6)
    assert out.dtype == xt.dtype
    close(out, RL.rms_norm(xj, wj, 1e-6), DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(dt, theta):
    rng = np.random.default_rng(1)
    xj, xt = pair(randn(rng, 2, 9, 3, 32), dt)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(PL.rope_inv_freq(32, theta).numpy(), RL.rope_inv_freq(32, theta),
                               rtol=1e-6)
    out = PL.apply_rope(xt, torch.from_numpy(pos), theta)
    assert out.dtype == xt.dtype
    close(out, RL.apply_rope(xj, jnp.asarray(pos), theta), DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mrope(dt):
    rng = np.random.default_rng(2)
    xj, xt = pair(randn(rng, 2, 7, 4, 32), dt)
    pos = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    sections = (4, 6, 6)
    out = PL.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    close(out, RL.apply_mrope(xj, jnp.asarray(pos), 1e6, sections), DTYPES[dt][2])
    with pytest.raises(ValueError, match="sections"):
        PL.apply_mrope(xt, torch.from_numpy(pos), 1e6, (4, 4, 4))


ATTN_SHAPES = [(2, 16, 4, 2, 32), (1, 24, 4, 4, 16), (2, 16, 6, 1, 64)]  # (B, S, H, KH, Dh)


def qkv(seed, b, s, h, kh, dh, dt):
    rng = np.random.default_rng(seed)
    return [pair(randn(rng, b, s, n, dh), dt) for n in (h, kh, kh)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_full(dt, shape, causal):
    (qj, qt), (kj, kt), (vj, vt) = qkv(3, *shape, dt)
    out = PL.attention_full(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    close(out, RL.attention_full(qj, kj, vj, causal=causal), DTYPES[dt][2])


def test_attention_full_q_offset():
    (qj, qt), (kj, kt), (vj, vt) = qkv(4, 2, 16, 4, 2, 32, "f32")
    close(PL.attention_full(qt[:, 8:], kt, vt, q_offset=8),
          RL.attention_full(qj[:, 8:], kj, vj, q_offset=8), F32_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", [(8, 8), (4, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_blockwise(dt, blocks, causal):
    (qj, qt), (kj, kt), (vj, vt) = qkv(5, 2, 16, 4, 2, 32, dt)
    qb, kb = blocks
    out = PL.attention_blockwise(qt, kt, vt, q_block=qb, kv_block=kb, causal=causal)
    close(out, RL.attention_blockwise(qj, kj, vj, q_block=qb, kv_block=kb, causal=causal),
          DTYPES[dt][2])
    with pytest.raises(ValueError, match="divide"):
        PL.attention_blockwise(qt, kt, vt, q_block=5, kv_block=8)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", [(8, 8), (16, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_forward_out_and_lse(dt, blocks, causal):
    (qj, qt), (kj, kt), (vj, vt) = qkv(6, 2, 16, 6, 2, 32, dt)
    qb, kb = blocks
    out, lse = PF._fwd_impl(qt, kt, vt, causal, qb, kb)
    r_out, r_lse = RF._fwd_impl(qj, kj, vj, causal, qb, kb)
    assert out.dtype == qt.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == tuple(r_lse.shape) == (2, 16, 2, 3)
    close(out, r_out, DTYPES[dt][2])
    close(lse, r_lse, F32_TOL)  # the log-sum-exp is f32 in both, from the same f32 scores
    close(PF.flash_attention_ref(qt, kt, vt, causal, qb, kb), RF.flash_attention_ref(
        qj, kj, vj, causal, qb, kb), DTYPES[dt][2])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cur", [0, 5, 15])
def test_attention_decode(dt, cur):
    rng = np.random.default_rng(7)
    qj, qt = pair(randn(rng, 2, 1, 4, 32), dt)
    kj, kt = pair(randn(rng, 2, 16, 2, 32), dt)
    vj, vt = pair(randn(rng, 2, 16, 2, 32), dt)
    out = PL.attention_decode(qt, kt, vt, cur)
    close(out, RL.attention_decode(qj, kj, vj, jnp.int32(cur)), DTYPES[dt][2])


def test_attention_decode_mixed_dtypes():
    """f32 queries against a bf16 cache: both packages promote alike."""
    rng = np.random.default_rng(8)
    qj, qt = pair(randn(rng, 2, 1, 4, 32), "f32")
    kj, kt = pair(randn(rng, 2, 16, 2, 32), "bf16")
    vj, vt = pair(randn(rng, 2, 16, 2, 32), "bf16")
    ref = RL.attention_decode(qj, kj, vj, jnp.int32(9))
    out = PL.attention_decode(qt, kt, vt, 9)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    close(out, ref, F32_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(dt, kind):
    rng = np.random.default_rng(9)
    xj, xt = pair(randn(rng, 2, 5, 32), dt)
    names = ("wi_gate", "wo") + (() if kind == "gelu" else ("wi_up",))
    shapes = {"wi_gate": (32, 64), "wi_up": (32, 64), "wo": (64, 32)}
    both = {n: pair(randn(rng, *shapes[n], scale=0.2), dt) for n in names}
    out = PL.mlp_apply({n: t for n, (_, t) in both.items()}, xt, kind)
    assert out.dtype == xt.dtype
    close(out, RL.mlp_apply({n: j for n, (j, _) in both.items()}, xj, kind), DTYPES[dt][2])
    with pytest.raises(KeyError):
        PL.mlp_apply({n: t for n, (_, t) in both.items()}, xt, "relu")
