"""The CUDA RMSNorm kernel on the card, against its plain PyTorch version
(``ref.rmsnorm_reference``, the model's ``layers.rms_norm``). Every test
here needs a CUDA device: each carries the ``gpu`` marker and skips where
there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_rmsnorm.py
"""
import pytest

torch = pytest.importorskip("torch")

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # the reference's bars (test_kernels.py)
SHAPES = [
    (64, 128), (2, 32, 64), (256, 512),  # test_kernels.py's
    (2048, 1024), (2048, 2048), (4, 1024), (4, 2048),  # mamba2-370m prefill and decode
    (1000, 1024), (3, 8192), (5, 37),  # ragged rows, a wide row, a width no vector divides
    (8192, 128), (7, 1001), (9, 4096), (9, 4097),  # qk-norm rows, odd widths, the warp/block edge
    (4, 12288),  # Mistral's width: a block per row
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.bfloat16, torch.float32)])
def test_kernel_matches_plain_version(cuda, shape, dtype, w_dtype):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=cuda) * 0.1).to(w_dtype)
    before = rmsnorm_cuda.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    want = rmsnorm_reference(x, w)
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_cuda_calls_raise_and_never_fall_back(cuda):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    x, w = torch.randn(8, 64, device=cuda), torch.zeros(64, device=cuda)
    before = rmsnorm_cuda.launches
    with pytest.raises(TypeError):  # the plain version would take float16
        rmsnorm(x.half(), w.half())
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x.t(), torch.zeros(8, device=cuda))
    assert rmsnorm_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1024, 1001, 128, 12288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_rows_match_plain_version(cuda, d, dtype):
    """x starting one element past a 16-byte boundary (a slice of a larger
    buffer): the kernel takes its element-load path and agrees as well."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

    rows = 33
    g = torch.Generator(device=cuda).manual_seed(d)
    buf = torch.randn(rows * d + 1, generator=g, device=cuda).to(dtype)
    x = buf[1:].view(rows, d)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = (torch.randn(d, generator=g, device=cuda) * 0.1).to(dtype)
    out = rmsnorm_cuda(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rmsnorm_reference(x, w).float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_width_limit_raises(cuda):
    from repro_torch.kernels.rmsnorm.kernel import max_width, rmsnorm_cuda

    d = max_width(torch.float32) + 4
    with pytest.raises(ValueError, match="exceed"):
        rmsnorm_cuda(torch.zeros(1, d, device=cuda), torch.zeros(d, device=cuda))
