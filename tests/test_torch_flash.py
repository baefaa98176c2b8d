"""The port's flash-attention entry point on the CPU, where it runs the
kernel's plain version, against the reference's Pallas kernel in interpret
mode, on the reference's own cases (``test_kernels.FLASH_CASES``) and bars
(2e-2 in bf16, 2e-5 in f32). The CUDA kernel itself runs only on a card:
``test_torch_gpu_flash.py`` holds it against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as ref_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from test_kernels import FLASH_CASES  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def inputs(b, s, h, kh, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, n, dh)).astype(np.float32) for n in (h, kh, kh)]
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs])


def tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-5


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_port_matches_interpret_kernel(case, causal):
    b, s, h, kh, dh, qb, kb, dtype = case
    (qj, kj, vj), (qt, kt, vt) = inputs(b, s, h, kh, dh, dtype)
    launches = K.flash_attention_cuda.launches
    out = flash_attention(qt, kt, vt, causal, qb, kb)
    assert K.flash_attention_cuda.launches == launches  # the CPU never reaches the kernel
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want = ref_flash(qj, kj, vj, causal, qb, kb, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference_oracle(case, causal):
    """``attention_reference`` against the reference's own oracle, both in
    the kernel's (B, H, S, Dh) layout."""
    b, s, h, kh, dh, _, _, dtype = case
    (qj, kj, vj), (qt, kt, vt) = inputs(b, s, h, kh, dh, dtype, seed=1)
    bhsd = lambda x: x.transpose(1, 2)  # noqa: E731
    out = attention_reference(bhsd(qt), bhsd(kt), bhsd(vt), causal=causal)
    want = ref_attention(*(x.transpose(0, 2, 1, 3) for x in (qj, kj, vj)), causal=causal)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))


def test_ragged_sequence_and_uneven_kv():
    """Sq ≠ Skv and a sequence no tile divides: same top-left-aligned causal
    mask as the reference's oracle."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 4, 40, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 72, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 72, 32)).astype(np.float32)
    for causal in (True, False):
        out = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
        want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


class _OnXpu(torch.Tensor):
    """A tensor that reports a device with no flash path."""

    @property
    def device(self):
        return torch.device("xpu")


def test_contract_and_device_checks():
    q = torch.zeros(1, 96, 4, 32)
    k = torch.zeros(1, 96, 2, 32)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, k, True, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 64, 3, 32), k[:, :64], k[:, :64])
    # meta tensors take the meta path (the dry run): the kernel's output, no values
    out = flash_attention(q.to("meta"), k.to("meta"), k.to("meta"), True, 96, 96)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="no path"):
        flash_attention(torch.Tensor._make_subclass(_OnXpu, q.to("meta")), k.to("meta"), k.to("meta"),
                        True, 96, 96)
    # the kernel wrapper takes CUDA tensors only, and raises before any build
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_cuda(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_strided_model_layout_views_match_contiguous(dtype, causal):
    """q, k and v sliced from one fused (B, S, H + 2 KH, Dh) projection: the
    entry point takes the non-contiguous views as they are (the CUDA kernel
    reads them through their strides), gives what contiguous copies give,
    and both match the interpret-mode Pallas kernel at the reference's bars."""
    b, s, h, kh, dh = 2, 128, 8, 2, 64
    rng = np.random.default_rng(5)
    fused = rng.standard_normal((b, s, h + 2 * kh, dh)).astype(np.float32)
    ft = torch.from_numpy(fused).to(TORCH_DTYPE[dtype])
    q, k, v = ft[:, :, :h], ft[:, :, h:h + kh], ft[:, :, h + kh:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    assert all(K.kernel_reads(x) for x in (q, k, v))  # the kernel would take them in place
    out = flash_attention(q, k, v, causal, 64, 64)
    again = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal, 64, 64)
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    fj = jnp.asarray(fused).astype(dtype)
    want = ref_flash(fj[:, :, :h], fj[:, :, h:h + kh], fj[:, :, h + kh:], causal, 64, 64, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 256, "tensor_cores"), (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores"), (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"), (torch.float32, 256, "cuda_cores"),
])
def test_route_is_fixed_by_dtype_and_head_dim(dtype, dh, want):
    """The dispatch rule: bf16 at Dh 64, 128 and 256 runs on the tensor
    cores, f32 (whose 2e-5 bar no bf16 or TF32 product meets) and the
    reduced configs' bf16 Dh 16 and 32 on the CUDA cores. A pure function
    of the two: the same answer every call, whatever else the call holds."""
    assert K.route(dtype, dh) == want
    assert K.route(dtype, dh) == K.route(dtype, dh)
    assert set(K.launches_by_route) == set(K.ROUTES) == {"tensor_cores", "cuda_cores"}
    assert set(K.TC_HEAD_DIMS) <= set(K.HEAD_DIMS)


def test_kernel_reads_strides_as_tma_takes_them():
    """Which layouts the kernel reads in place (the head dim contiguous, the
    base and every other stride 16-byte aligned), and the (batch, row,
    head) strides it is handed for a transposed model-layout view."""
    x = torch.zeros(2, 40, 6, 64, dtype=torch.bfloat16)  # (B, S, H, Dh)
    assert K.kernel_reads(x)
    assert K.kernel_strides(x.transpose(1, 2)) == (40 * 6 * 64, 6 * 64, 64)
    assert K.kernel_reads(torch.zeros(2, 40, 12, 64, dtype=torch.bfloat16)[:, :, 6:])
    assert not K.kernel_reads(x.transpose(2, 3))  # head dim not contiguous
    assert not K.kernel_reads(torch.zeros(2, 40, 6, 66, dtype=torch.bfloat16)[..., :64])  # 132 B rows
    assert not K.kernel_reads(torch.zeros(2 * 40 * 6 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 40, 6, 64))
    one = torch.zeros(1, 40, 1, 64, dtype=torch.float32)  # size-1 dims: any stride serves
    assert K.kernel_strides(one.transpose(1, 2)) == (4, 64, 4)
    with pytest.raises(ValueError, match="16-byte"):
        K.kernel_strides(torch.zeros(2, 40, 6, 66)[..., :64])
