"""CUDA flash-attention kernel for Hopper: build, bind and launch.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of ``src/repro/kernels/flash_attention/kernel.py``: the
forward pass of causal (or full) GQA attention with an online softmax over
KV tiles. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with plain C entry points, at first use, into ``build/kernels/``
(``kernels._build``), and bound with ``ctypes``. Nothing here runs at
import: this module imports cleanly on a machine with no CUDA toolkit.

The source has two routes, and :func:`route` picks one from the dtype and
the head dim alone (a fixed rule, not a fallback: a failed build or launch
of either raises):

  * ``"tensor_cores"``: bf16 at Dh 64, 128 or 256. wgmma products with P
    rounded to bf16, K/V tiles by TMA into a two-stage ring under
    mbarriers, a producer warpgroup and two consumer warpgroups (the query
    heads of one KV group share each K/V tile).
  * ``"cuda_cores"``: f32 at every Dh (its 2e-5 bar is beyond bf16 or TF32
    tensor cores) and bf16 at Dh 16 and 32 (the reduced test configs).
    f32 FMAs, one block per (64 query rows, head, batch row).

Both read q, k and v in place through their strides (the model's
(B, S, H, Dh) activations, or slices of one fused projection) and write the
output (B, S, H, Dh), so the wrapper copies nothing. Given an ``lse``
tensor, both also write each row's log-sum-exp into it (the training
forward: ``ops.flash_attention`` under autograd saves it for the backward).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from .._build import Library, stream_handle

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# IEEE expf/exp2f and division, no fast math: the softmax runs as the reference's
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64, 128, 256)  # the CUDA-core route's template instances
TC_HEAD_DIMS = (64, 128, 256)  # the tensor-core route's
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_cores", "cuda_cores")

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)
launches_by_route = dict.fromkeys(ROUTES, 0)  # kernel launches since the last reset, per route


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a call takes: ``"tensor_cores"`` for bf16 at Dh 64, 128 or
    256, ``"cuda_cores"`` otherwise."""
    return "tensor_cores" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "cuda_cores"


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_launch.argtypes = [vp] * 5 + [ci] * 7 + [ll, ci, ctypes.c_float, vp]
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_tc_launch.argtypes = [vp] * 5 + [ci] * 6 + [ll, ci, ctypes.c_float, vp]
    lib.flash_attention_tc_launch.restype = ci
    lib.flash_attention_wgmma_tile.argtypes = [vp] * 5 + [ci, vp]
    lib.flash_attention_wgmma_tile.restype = ci
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


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def kernel_reads(x: torch.Tensor) -> bool:
    """Whether the kernel reads this 4-D tensor in place: the last (head)
    dim contiguous, the base and every other stride of a dim of size > 1 a
    positive multiple of 16 bytes (TMA's rule, and the 16-byte vector
    loads' of the CUDA-core route)."""
    item = x.element_size()
    if x.data_ptr() % 16 or (x.shape[3] > 1 and x.stride(3) != 1):
        return False
    return all(x.shape[d] == 1 or (x.stride(d) > 0 and x.stride(d) * item % 16 == 0) for d in (0, 1, 2))


def kernel_strides(x: torch.Tensor) -> tuple:
    """Element strides (batch, row, head) of a (B, Hn, S, Dh) view the
    kernel reads (:func:`kernel_reads`; raises otherwise). A dim of size 1
    gets a stride of one 16-byte vector: any stride serves at index 0."""
    if not kernel_reads(x):
        raise ValueError(f"flash_attention_cuda: strides {tuple(x.stride())} at {x.data_ptr() % 16} bytes "
                         "past 16-byte alignment: the head dim must be contiguous, the data and every "
                         "other stride 16-byte aligned")
    return tuple(x.stride(d) if x.shape[d] > 1 else 16 // x.element_size() for d in (0, 2, 1))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, H, Sq, Dh), k and v
    (B, KH, Skv, Dh), views of any strides that :func:`kernel_strides`
    takes (contiguous, or the model's (B, S, H, Dh) transposed), one float
    dtype, on one CUDA device, H a multiple of KH and Dh one of
    :data:`HEAD_DIMS`. Returns the output (B, H, Sq, Dh) in q's dtype, a
    view of a contiguous (B, Sq, H, Dh) tensor. ``lse``, where given, is a
    contiguous f32 (B, Sq, H) tensor on q's device that the kernel fills
    with each row's log-sum-exp (natural log, of the scaled and masked
    scores). Raises if an argument is off or the launch fails; never
    synchronises."""
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
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not in {list(DTYPES)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {dh} not in {HEAD_DIMS}")
    if tuple(k.shape) != (b, kh, skv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    if lse is not None and (lse.dtype != torch.float32 or tuple(lse.shape) != (b, sq, h)
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse: expected a contiguous float32 {(b, sq, h)} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention_cuda: empty key sequence")
    strides = (ctypes.c_longlong * 12)(*(kernel_strides(q) + kernel_strides(k) + kernel_strides(v)
                                         + kernel_strides(out)))
    lib = _LIB.get()
    stream = stream_handle(q.get_device())
    which = route(q.dtype, dh)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    if which == "tensor_cores":
        err = lib.flash_attention_tc_launch(*ptrs, b, h, kh, sq, skv, dh, strides, int(causal),
                                            1.0 / math.sqrt(dh), stream)
    else:
        err = lib.flash_attention_launch(*ptrs, DTYPES[q.dtype], b, h, kh, sq, skv, dh, strides,
                                         int(causal), 1.0 / math.sqrt(dh), stream)
    _check(lib, err, f"flash_attention kernel launch ({which})")
    flash_attention_cuda.launches += 1
    launches_by_route[which] += 1
    return out


flash_attention_cuda.launches = 0  # kernel launches since the last reset, both routes


def reset_launches() -> None:
    """Zero the launch count and the per-route counts."""
    flash_attention_cuda.launches = 0
    for key in launches_by_route:
        launches_by_route[key] = 0


def wgmma_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """One wgmma tile of each of the tensor-core route's products, loaded by
    the same TMA maps and read through the same descriptors: q, k, v
    (64, Dh) contiguous bf16 on the card, Dh one of :data:`TC_HEAD_DIMS`.
    Returns S = q kᵀ (64, 64) and bf16(S) v (64, Dh), both f32; for checking
    the swizzle and the descriptors against a plain matrix product. Not a
    launch of the attention kernel: counts nothing."""
    dh = q.shape[-1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.dtype != torch.bfloat16 or tuple(x.shape) != (64, dh):
            raise ValueError(f"{name}: expected a (64, {dh}) bf16 CUDA tensor")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    if dh not in TC_HEAD_DIMS:
        raise ValueError(f"wgmma_tile: head_dim {dh} not in {TC_HEAD_DIMS}")
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty((64, dh), dtype=torch.float32, device=q.device)
    lib = _LIB.get()
    err = lib.flash_attention_wgmma_tile(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
                                         o.data_ptr(), dh, stream_handle(q.get_device()))
    _check(lib, err, "wgmma tile launch")
    return s, o
