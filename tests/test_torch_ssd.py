"""The port's SSD on the CPU against the reference's: the plain versions
(``ssd_reference``, ``ssd_naive``, ``ssd_decode_step``) against the JAX
oracles, and the entry point ``ops.ssd`` (which runs the plain version on
CPU tensors) against the Pallas kernel in interpret mode, over the
reference's own cases (``test_kernels.SSD_CASES``) and bars: y within 5e-2
(bf16) / 1e-3 (f32), the state within 1e-3. The same inputs, made with
numpy, go to both packages. The CUDA kernel itself runs only on a card:
``test_torch_gpu_ssd.py`` holds it against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd.ops import ssd as ref_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_decode_step as ref_decode_step  # noqa: E402
from repro.kernels.ssd.ref import ssd_naive as ref_naive  # noqa: E402
from repro.kernels.ssd.ref import ssd_reference as ref_reference  # noqa: E402
from repro_torch.kernels.ssd import kernel as K  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_decode_step, ssd_naive, ssd_reference  # noqa: E402
from test_kernels import SSD_CASES  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
H_TOL = 1e-3


def y_tol(dtype):
    return 5e-2 if dtype == jnp.bfloat16 else 1e-3


def inputs(b, s, h, p, n, dtype, seed=0):
    """(jax arrays, torch tensors) of x, dt, a, B, C as the reference's
    tests draw them: x in ``dtype``, dt = softplus(normal), a = -exp(normal),
    B and C normal in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    jx = [jnp.asarray(x).astype(dtype)] + [jnp.asarray(v) for v in (dt, a, bm, cm)]
    tx = [torch.from_numpy(x).to(TORCH_DTYPE[dtype])] + [torch.from_numpy(v) for v in (dt, a, bm, cm)]
    return jx, tx


def close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_port_matches_interpret_kernel(case):
    b, s, h, p, n, chunk, dtype = case
    jx, tx = inputs(b, s, h, p, n, dtype)
    launches = K.ssd_cuda.launches
    y, h_final = ssd(*tx, chunk=chunk)
    assert K.ssd_cuda.launches == launches  # the CPU never reaches the kernel
    assert y.dtype == tx[0].dtype and y.shape == tx[0].shape
    assert h_final.dtype == torch.float32 and h_final.shape == (b, h, p, n)
    y_k, h_k = ref_ssd(*jx, chunk=chunk, interpret=True)
    close(y, y_k, y_tol(dtype))
    close(h_final, h_k, H_TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_versions_match_reference_oracles(case):
    """``ssd_reference`` and ``ssd_naive`` against the reference's, and the
    chunked form against the token-by-token one."""
    b, s, h, p, n, chunk, dtype = case
    jx, tx = inputs(b, s, h, p, n, dtype, seed=1)
    y_c, h_c = ssd_reference(*tx, chunk=chunk)
    y_n, h_n = ssd_naive(*tx)
    assert y_c.dtype == y_n.dtype == tx[0].dtype
    ry_c, rh_c = ref_reference(*jx, chunk=chunk)
    ry_n, rh_n = ref_naive(*jx)
    close(y_c, ry_c, y_tol(dtype))
    close(h_c, rh_c, H_TOL)
    close(y_n, ry_n, y_tol(dtype))
    close(h_n, rh_n, H_TOL)
    close(y_c, y_n.float(), y_tol(dtype))
    close(h_c, h_n, H_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_chunk_invariance(chunk):
    """The reference's oracle property on the port: chunked SSD == the naive
    recurrence for every chunk size, at the reference's bars."""
    _, tx = inputs(2, 128, 4, 16, 8, jnp.float32, seed=2)
    y_c, h_c = ssd_reference(*tx, chunk=chunk)
    y_n, h_n = ssd_naive(*tx)
    np.testing.assert_allclose(y_c.numpy(), y_n.numpy(), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(h_c.numpy(), h_n.numpy(), atol=5e-5, rtol=1e-3)


def test_initial_state_handoff():
    """Splitting a sequence in two and carrying h across == one pass (the
    prefill → decode contract), and the port's h0 path equals the
    reference's."""
    jx, (x, dt, a, bm, cm) = inputs(1, 64, 2, 8, 4, jnp.float32, seed=3)
    y_full, h_full = ssd_reference(x, dt, a, bm, cm, chunk=16)
    y1, h1 = ssd_reference(x[:, :32], dt[:, :32], a, bm[:, :32], cm[:, :32], chunk=16)
    y2, h2 = ssd_reference(x[:, 32:], dt[:, 32:], a, bm[:, 32:], cm[:, 32:], chunk=16, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5, rtol=1e-3)
    jxs, jdt, ja, jbm, jcm = jx
    _, rh1 = ref_reference(jxs[:, :32], jdt[:, :32], ja, jbm[:, :32], jcm[:, :32], chunk=16)
    ry2, rh2 = ref_reference(jxs[:, 32:], jdt[:, 32:], ja, jbm[:, 32:], jcm[:, 32:], chunk=16,
                             h0=rh1)
    close(y2, ry2, 1e-3)
    close(h2, rh2, H_TOL)
    yn2, hn2 = ssd_naive(x[:, 32:], dt[:, 32:], a, bm[:, 32:], cm[:, 32:], h0=h1)
    close(yn2, ry2, 1e-3)
    close(hn2, rh2, H_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_step_matches_reference(dtype):
    rng = np.random.default_rng(4)
    b, h, p, n = 2, 4, 16, 8
    arrs = [rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
            np.logaddexp(rng.standard_normal((b, h)), 0.0), -np.exp(rng.standard_normal(h)),
            rng.standard_normal((b, n)), rng.standard_normal((b, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    jx[1] = jx[1].astype(dtype)
    tx = [torch.from_numpy(a) for a in arrs]
    tx[1] = tx[1].to(TORCH_DTYPE[dtype])
    y, h_new = ssd_decode_step(*tx)
    ry, rh = ref_decode_step(*jx)
    assert y.dtype == tx[1].dtype and h_new.dtype == torch.float32
    close(y, ry, y_tol(dtype))
    close(h_new, rh, 1e-5)


def test_contract_and_device_checks():
    _, (x, dt, a, bm, cm) = inputs(1, 96, 2, 16, 8, jnp.float32)
    with pytest.raises(ValueError, match="divide"):
        ssd(x, dt, a, bm, cm, chunk=64)
    y, _ = ssd(x, dt, a, bm, cm, chunk=512)  # chunk = min(chunk, S)
    assert y.shape == x.shape
    with pytest.raises(ValueError, match="no path"):
        ssd(*(t.to("meta") for t in (x, dt, a, bm, cm)), chunk=32)
    # the kernel wrapper takes CUDA tensors only, and raises before any build
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_cuda(x, dt, a, bm, cm, 32)


# (x dtype, B/C dtype, chunk, P, N) -> the route kernel.route must pick: bf16
# throughout with every size 64 or 128 takes the tensor cores, anything else
# the CUDA cores
ROUTE_RULE = [
    ((torch.bfloat16, torch.bfloat16, 64, 64, 128), "tensor_cores"),  # Mamba2-370m's serving prefill
    ((torch.bfloat16, torch.bfloat16, 128, 64, 128), "tensor_cores"),  # ops.ssd's default chunk
    ((torch.bfloat16, torch.bfloat16, 64, 128, 64), "tensor_cores"),
    ((torch.bfloat16, torch.bfloat16, 128, 128, 128), "tensor_cores"),
    ((torch.bfloat16, torch.bfloat16, 32, 64, 128), "cuda_cores"),  # chunk below a wgmma tile
    ((torch.bfloat16, torch.bfloat16, 96, 64, 128), "cuda_cores"),  # chunk no multiple of 64
    ((torch.bfloat16, torch.bfloat16, 64, 32, 128), "cuda_cores"),  # head dim
    ((torch.bfloat16, torch.bfloat16, 64, 64, 16), "cuda_cores"),  # state
    ((torch.bfloat16, torch.float32, 64, 64, 128), "cuda_cores"),  # B, C in f32 (the reference's tests)
    ((torch.float32, torch.bfloat16, 64, 64, 128), "cuda_cores"),
    ((torch.float32, torch.float32, 64, 64, 128), "cuda_cores"),  # f32 keeps its f32 products
]


@pytest.mark.parametrize("args,want", ROUTE_RULE)
def test_route_rule(args, want):
    assert K.route(*args) == want


def model_slices(b, s, h, p, n, dtype, seed):
    """(jax arrays, torch tensors) of x, dt, a, B, C as the model passes
    them: x, B and C views of one (B, S, H*P + 2N) projection (strided, not
    copied), dt = softplus(normal), a = -exp(normal)."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    t = torch.from_numpy(xbc).to(TORCH_DTYPE[dtype])
    tx = [t[..., :h * p].view(b, s, h, p), torch.from_numpy(dt), torch.from_numpy(a),
          t[..., h * p:h * p + n], t[..., h * p + n:]]
    j = jnp.asarray(xbc).astype(dtype)
    jx = [j[..., :h * p].reshape(b, s, h, p), jnp.asarray(dt), jnp.asarray(a), j[..., h * p:h * p + n],
          j[..., h * p + n:]]
    return jx, tx


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("chunk", [64, 128])
def test_ops_on_model_slices_matches_references(dtype, chunk):
    """``ops.ssd`` on the model's strided slices (on the CPU: the plain
    version) against ``ssd_reference`` on contiguous copies and the Pallas
    kernel in interpret mode; the slices stay views, and on the card the
    tensor-core route reads exactly these strides (``kernel_reads``)."""
    b, s, h, p, n = 1, 256, 2, 64, 128
    jx, tx = model_slices(b, s, h, p, n, dtype, seed=chunk)
    x, dt, a, bm, cm = tx
    assert not x.is_contiguous() and not bm.is_contiguous() and not cm.is_contiguous()
    launches = K.ssd_cuda.launches
    y, h_final = ssd(x, dt, a, bm, cm, chunk=chunk)
    assert K.ssd_cuda.launches == launches
    assert y.dtype == x.dtype and y.shape == x.shape and h_final.shape == (b, h, p, n)
    y_c, h_c = ssd_reference(*(t.contiguous() for t in tx), chunk=chunk)
    assert torch.equal(y, y_c) and torch.equal(h_final, h_c)
    y_k, h_k = ref_ssd(*jx, chunk=chunk, interpret=True)
    close(y, y_k, y_tol(dtype))
    close(h_final, h_k, H_TOL)
    if dtype == jnp.bfloat16:
        assert all(K.kernel_reads(t) for t in (x, bm, cm))
        assert K.route(x.dtype, bm.dtype, chunk, p, n) == "tensor_cores"


def test_kernel_reads_rule():
    """The tensor-core route's stride rule: last dim contiguous, the base and
    the other strides 16-byte aligned; a dim of size 1 may have any stride."""
    t = torch.zeros(2, 64, 4 * 64 + 256, dtype=torch.bfloat16)
    assert K.kernel_reads(t[..., :256].view(2, 64, 4, 64))
    assert K.kernel_reads(t[..., 256:384])
    assert not K.kernel_reads(t[..., 1:129])  # base 2 bytes past alignment
    assert not K.kernel_reads(t[..., :256].view(2, 64, 4, 64).transpose(2, 3))  # last dim strided
    assert not K.kernel_reads(torch.zeros(2, 64, 129, dtype=torch.bfloat16)[..., :128])  # row of 258 bytes
    assert K.kernel_reads(torch.zeros(1, 64, 129, dtype=torch.bfloat16)[:, :1, :128])  # size-1 dims
