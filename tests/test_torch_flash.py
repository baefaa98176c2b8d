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


def test_contract_and_device_checks():
    q = torch.zeros(1, 96, 4, 32)
    k = torch.zeros(1, 96, 2, 32)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, k, True, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 64, 3, 32), k[:, :64], k[:, :64])
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"), True, 96, 96)
    # the kernel wrapper takes CUDA tensors only, and raises before any build
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_cuda(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous())
