"""CUDA flash-attention kernel for Hopper: build, bind and launch.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention/kernel.py``: the
forward pass of causal (or full) GQA attention with an online softmax over
KV tiles, in f32. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, at first use, into ``build/kernels/``
(``kernels._build``), and bound with ``ctypes``. Nothing here runs at
import: this module imports cleanly on a machine with no CUDA toolkit.

One block per (q tile of 64 rows, query head, batch row); the block loops
over the KV tiles itself and stops at the causal diagonal. The kernel picks
its own tiles, so any sequence length works (the ragged edge is masked).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import Library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# IEEE expf and division, no fast math: the softmax runs as the reference's
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's template instances (16: reduced configs)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [ci] * 8 + [ctypes.c_float, vp]
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


_LIB = Library("flash_attention", SOURCE, NVCC_FLAGS, _bind)


def build() -> Path:
    """Compile the kernel library if this source/flag combination has not
    been built yet; returns its path and sets :data:`build_log`."""
    global build_log
    path = _LIB.build()
    build_log = _LIB.log
    return path


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, H, Sq, Dh), k and v
    (B, KH, Skv, Dh), contiguous, one float dtype, on one CUDA device, H a
    multiple of KH and Dh one of :data:`HEAD_DIMS`. Returns the output
    (B, H, Sq, Dh) in q's dtype. Raises if an argument is off or the launch
    fails; never synchronises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda: q, k, v must be (B, H, S, Dh)")
    b, h, sq, dh = q.shape
    kh, skv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError(f"{name}: on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, q has {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte vectors; the data must be 16-byte aligned")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not in {list(DTYPES)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {dh} not in {HEAD_DIMS}")
    if tuple(k.shape) != (b, kh, skv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention_cuda: empty key sequence")
    lib = _LIB.get()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        DTYPES[q.dtype], b, h, kh, sq, skv, dh, int(causal),
        ctypes.c_float(1.0 / math.sqrt(dh)), ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0  # kernel launches since the last reset
