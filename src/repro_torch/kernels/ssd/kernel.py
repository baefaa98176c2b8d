"""CUDA SSD chunk-scan kernel for Hopper: build, bind and launch.

The kernel (``csrc/ssd.cu``) replaces the Pallas TPU kernel ``_ssd_kernel``
of ``src/repro/kernels/ssd/kernel.py``: the Mamba-2 SSD chunk scan, y and
the final state h, in f32. It is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, at first use, into
``build/kernels/`` (``kernels._build``), and bound with ``ctypes``. Nothing
here runs at import: this module imports cleanly on a machine with no CUDA
toolkit.

One block per (head, batch row) loops over the chunks itself, carrying h in
shared memory (the TPU kernel carries it in VMEM across a sequential grid
axis).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .._build import Library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
# IEEE expf, no fast math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128  # the largest chunk, head dim and state the kernel takes

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.ssd_launch.restype = ci
    lib.ssd_smem_bytes.argtypes = [ci, ci, ci]
    lib.ssd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_error_string.argtypes = [ci]
    lib.ssd_error_string.restype = ctypes.c_char_p


_LIB = Library("ssd", SOURCE, NVCC_FLAGS, _bind)


def build() -> Path:
    """Compile the kernel library if this source/flag combination has not
    been built yet; returns its path and sets :data:`build_log`."""
    global build_log
    path = _LIB.build()
    build_log = _LIB.log
    return path


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: x (B, S, H, P) float32 or
    bfloat16, dt (B, S, H) and a (H,) float32, b_mat and c_mat (B, S, N)
    float32 or bfloat16, all contiguous on one CUDA device; ``chunk`` ≤ 128
    divides S, and P, N ≤ 128. Returns (y (B, S, H, P) in x's dtype, h_final
    (B, H, P, N) float32). Raises if an argument is off or the launch fails;
    never synchronises."""
    if x.dim() != 4:
        raise ValueError(f"ssd_cuda: x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    want = {"dt": (bsz, s, h), "a": (h,), "b_mat": (bsz, s, n), "c_mat": (bsz, s, n)}
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {list(DTYPES)}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype} and {a.dtype}")
    if c_mat.dtype != b_mat.dtype:
        raise TypeError(f"c_mat: dtype {c_mat.dtype}, b_mat has {b_mat.dtype}")
    if not 0 < chunk <= MAX_DIM or s % chunk:
        raise ValueError(f"ssd_cuda: chunk {chunk} must be in 1..{MAX_DIM} and divide S = {s}")
    if not 0 < p <= MAX_DIM or not 0 < n <= MAX_DIM:
        raise ValueError(f"ssd_cuda: head dim {p} and state {n} must be in 1..{MAX_DIM}")
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, h_final
    lib = _LIB.get()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_launch(
        *(ctypes.c_void_p(t.data_ptr()) for t in (x, dt, a, b_mat, c_mat, y, h_final)),
        DTYPES[x.dtype], DTYPES[b_mat.dtype], bsz, s, h, p, n, chunk, ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = lib.ssd_error_string(err).decode()
        smem = lib.ssd_smem_bytes(chunk, p, n)
        raise RuntimeError(f"ssd kernel launch failed: {msg} ({err}); "
                           f"it asked for {smem} bytes of shared memory")
    ssd_cuda.launches += 1
    return y, h_final


ssd_cuda.launches = 0  # kernel launches since the last reset
