"""The port's RMSNorm entry point on the CPU, where it runs the kernel's
plain version, against the reference's Pallas kernel in interpret mode, on
the reference's own shapes and bars (``test_kernels.test_rmsnorm_kernel``:
1e-5 in f32, 2e-2 in bf16). The same inputs, made with numpy, go to both
packages. The CUDA kernel itself runs only on a card:
``test_torch_gpu_rmsnorm.py`` holds it against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rmsnorm.ops import rmsnorm as ref_rmsnorm  # noqa: E402
from repro.models.layers import rms_norm as ref_rms_norm  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as K  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SHAPES = [((64, 128), 32), ((2, 32, 64), 16), ((256, 512), 128)]  # test_kernels.py's


def tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 1e-5


def inputs(shape, dtype, w_dtype=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    w_dtype = w_dtype or dtype
    return ((jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(w_dtype)),
            (torch.from_numpy(x).to(TORCH_DTYPE[dtype]), torch.from_numpy(w).to(TORCH_DTYPE[w_dtype])))


@pytest.mark.parametrize("shape,rb", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_matches_interpret_kernel(shape, rb, dtype):
    (xj, wj), (xt, wt) = inputs(shape, dtype)
    launches = K.rmsnorm_cuda.launches
    out = rmsnorm(xt, wt, row_block=rb)
    assert K.rmsnorm_cuda.launches == launches  # the CPU never reaches the kernel
    assert out.dtype == xt.dtype and out.shape == xt.shape
    want = ref_rmsnorm(xj, wj, row_block=rb, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("w_dtype", [jnp.float32, jnp.bfloat16])
def test_plain_version_is_the_layer_norm(w_dtype):
    """``rmsnorm_reference`` is ``layers.rms_norm``, the model's own norm,
    and matches the reference's on a ragged row count (1000 rows, which no
    256-row block divides) with the weight in either dtype."""
    assert rmsnorm_reference is rms_norm
    (xj, wj), (xt, wt) = inputs((1000, 64), jnp.bfloat16, w_dtype, seed=1)
    out = rmsnorm(xt, wt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_rms_norm(xj, wj), np.float32),
                               atol=2e-2, rtol=2e-2)


def test_contract_and_device_checks():
    x, w = torch.zeros(8, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="row_block"):
        rmsnorm(x, w, row_block=0)
    with pytest.raises(ValueError, match="no path"):
        rmsnorm(x.to("meta"), w.to("meta"))
    # the kernel wrapper takes CUDA tensors only, and raises before any build
    with pytest.raises(ValueError, match="CUDA"):
        K.rmsnorm_cuda(x, w)
    with pytest.raises(ValueError, match="rows, d"):
        K.rmsnorm_cuda(x, torch.zeros(8))


@pytest.mark.parametrize("shape", [(7, 1001), (1000, 128), (3, 4097)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_odd_and_misaligned_rows_match_interpret_kernel(shape, dtype):
    """Widths no 16-byte vector divides, qk-norm's d = 128, the warp/block
    edge past 4096, and x one element past an aligned base (the CUDA
    kernel's element-load path): the entry point against the interpret-mode
    Pallas kernel at the reference's bars."""
    (xj, wj), (xt, wt) = inputs(shape, dtype, seed=3)
    buf = torch.empty(xt.numel() + 1, dtype=xt.dtype)
    buf[1:] = xt.reshape(-1)
    x_off = buf[1:].view(shape)
    assert x_off.data_ptr() % 16 != 0
    out = rmsnorm(x_off, wt)
    want = ref_rmsnorm(xj, wj, row_block=shape[0], interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol(dtype), rtol=tol(dtype))


def test_width_limit():
    """The widest row the CUDA kernel takes (16 vectors of 16 bytes for each
    of a block's 512 threads) covers every config's norm, Mistral's 12,288
    included."""
    assert K.max_width(torch.bfloat16) == 65536 and K.max_width(torch.float32) == 32768
    from repro_torch.configs.registry import arch_names, get_config

    widest = max(get_config(n).d_model for n in arch_names())
    assert widest <= K.max_width(torch.float32)
