"""CUDA position-in-expert kernel for Hopper: build, bind and launch.

The kernel (``csrc/moe_positions.cu``) replaces no TPU kernel: it computes
the integers of the reference's token-major one-hot cumsum
(``src/repro/models/moe.py`` ``moe_apply``, a ``jnp.cumsum`` outside any
Pallas kernel), each flat assignment's rank among the earlier assignments to
its expert, in tiles of :data:`TILE` ids without the (N, E) one-hot. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
entry point, at first use, into ``build/kernels/`` (``kernels._build``), and
bound with ``ctypes``. Nothing here runs at import: this module imports
cleanly on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, stream_handle

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_positions.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TILE = 1024  # ids a block ranks (the source's TILE)
# the most experts the kernel takes: a block's shared count table is 32 × E
# int32, 128 KB at 1,024 (the source's MAX_EXPERTS; the card gives a block
# 227 KB)
MAX_EXPERTS = 1024
MAX_IDS = 2**31 - 1  # positions and counts are int32 inside the kernel

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _bind(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.moe_positions_launch.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, vp, vp, vp]
    lib.moe_positions_launch.restype = ctypes.c_int
    lib.moe_positions_error_string.argtypes = [ctypes.c_int]
    lib.moe_positions_error_string.restype = ctypes.c_char_p


_LIB = Library("moe_positions", SOURCE, NVCC_FLAGS, _bind)


def build() -> Path:
    """Compile the kernel library if this source/flag combination has not
    been built yet; returns its path and sets :data:`build_log`."""
    global build_log
    path = _LIB.build()
    build_log = _LIB.log
    return path


def check(flat_e: torch.Tensor, e: int) -> None:
    """Raise unless ``flat_e`` is a 1-D contiguous int64 tensor of at most
    :data:`MAX_IDS` ids and ``e`` lies in [1, :data:`MAX_EXPERTS`]: what the
    kernel takes, on any device."""
    if flat_e.dtype != torch.int64:
        raise TypeError(f"flat_e: dtype {flat_e.dtype}, the kernel takes int64")
    if flat_e.dim() != 1 or not flat_e.is_contiguous():
        raise ValueError(f"flat_e: must be 1-D and contiguous, got shape {tuple(flat_e.shape)}, "
                         f"strides {flat_e.stride()}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_positions: {e} experts, the kernel takes 1 to {MAX_EXPERTS}")
    if flat_e.shape[0] > MAX_IDS:
        raise ValueError(f"moe_positions: {flat_e.shape[0]} ids, the kernel takes at most {MAX_IDS}")


def moe_positions_cuda(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Launch the kernel on the current stream: ``flat_e`` (N,) on one CUDA
    device, as :func:`check` requires. Returns the (N,) int64 positions (0
    for an id outside [0, e), as the one-hot cumsum gives). Raises if an
    argument is off or the launch fails; never synchronises. One call
    launches twice (a rank pass and an add pass), whatever N."""
    if not flat_e.is_cuda:
        raise ValueError(f"flat_e: expected a CUDA tensor, got {flat_e.device}")
    check(flat_e, e)
    n = flat_e.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=flat_e.device)
    if n == 0:
        return out
    # the ranks, then each tile's counts
    scratch = torch.empty(n + -(-n // TILE) * e, dtype=torch.int32, device=flat_e.device)
    lib = _LIB.get()
    err = lib.moe_positions_launch(flat_e.data_ptr(), n, e, scratch.data_ptr(), out.data_ptr(),
                                   stream_handle(flat_e.get_device()))
    if err != 0:
        msg = lib.moe_positions_error_string(err).decode()
        raise RuntimeError(f"moe_positions kernel launch failed: {msg} ({err})")
    moe_positions_cuda.launches += 1
    return out


moe_positions_cuda.launches = 0  # wrapper calls that launched, since the last reset
