"""CUDA RMSNorm kernel for Hopper: build, bind and launch.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``_rmsnorm_kernel`` of ``src/repro/kernels/rmsnorm/kernel.py``: a row
RMSNorm with f32 statistics and a scale by (1 + w). It is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point,
at first use, into ``build/kernels/`` (``kernels._build``), and bound with
``ctypes``. Nothing here runs at import: this module imports cleanly on a
machine with no CUDA toolkit.

One block per row, so any row count works; d is any width (the block
strides over it).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
# IEEE sqrtf and division, no fast math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.rmsnorm_launch.restype = ci
    lib.rmsnorm_error_string.argtypes = [ci]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p


_LIB = Library("rmsnorm", SOURCE, NVCC_FLAGS, _bind)


def build() -> Path:
    """Compile the kernel library if this source/flag combination has not
    been built yet; returns its path and sets :data:`build_log`."""
    global build_log
    path = _LIB.build()
    build_log = _LIB.log
    return path


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on the current stream: x (rows, d) contiguous, w
    (d,) contiguous, each float32 or bfloat16, on one CUDA device. Returns
    the output (rows, d) in x's dtype. Raises if an argument is off or the
    launch fails; never synchronises."""
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm_cuda: x must be (rows, d) and w (d,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {list(DTYPES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if w.device != x.device:
        raise ValueError(f"w: on {w.device}, x on {x.device}")
    rows, d = x.shape
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if d == 0:
        raise ValueError("rmsnorm_cuda: empty rows")
    lib = _LIB.get()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), DTYPES[x.dtype], DTYPES[w.dtype], rows, d,
        ctypes.c_float(eps), ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} ({err})")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0  # kernel launches since the last reset
