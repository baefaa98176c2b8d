"""CUDA SSD chunk-scan kernel for Hopper: build, bind and launch.

The kernel (``csrc/ssd.cu``) replaces the Pallas TPU kernel ``_ssd_kernel``
of ``src/repro/kernels/ssd/kernel.py``: the Mamba-2 SSD chunk scan, y and
the final state h. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with plain C entry points, at first use, into ``build/kernels/``
(``kernels._build``), and bound with ``ctypes``. Nothing here runs at
import: this module imports cleanly on a machine with no CUDA toolkit.

B and C come as (B, S, N), one SSM group for every head, or as (B, S, G, N),
head h reading group h // (H / G); either way one launch a call (the
kernels take every B and C as (B, S, G, N), G = 1 a view of the first).

The source has two routes, and :func:`route` picks one from the dtypes and
the sizes alone (a fixed rule, not a fallback: a failed build or launch of
either raises). Both run one block per (head, batch row) that loops over
the chunks itself, carrying h on chip (the TPU kernel carries it in VMEM
across a sequential grid axis).

  * ``"tensor_cores"``: x, B and C in bf16 with chunk, P and N each 64 or
    128 (the serving path). wgmma products with f32 accumulators (the f32
    operands as bf16 hi + lo pairs), x, B and C tiles by TMA into a chunk
    ring fed by a producer warp, h in registers. x, B and C are read in
    place through their strides (:func:`kernel_reads`), dt through its own.
  * ``"cuda_cores"``: everything else, f32 included. f32 FMAs from shared
    memory; every input contiguous. Where one (head, batch row) instance
    would need more shared memory than a block has (chunk = P = N = 128),
    its head dim is split across blocks (:func:`cc_p_block`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import Library, stream_handle

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
# IEEE expf, no fast math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128  # the largest chunk, head dim and state the kernel takes
SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block can opt in to
CC_RT = 32  # rows of the CUDA-core route's C.B^T tile (csrc/ssd.cu cc::RT)
TC_DIMS = (64, 128)  # the tensor-core route's chunk, head dim and state sizes
ROUTES = ("tensor_cores", "cuda_cores")

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)
launches_by_route = dict.fromkeys(ROUTES, 0)  # kernel launches since the last reset, per route


def route(x_dtype: torch.dtype, bc_dtype: torch.dtype, chunk: int, p: int, n: int) -> str:
    """The route a call takes: ``"tensor_cores"`` for x, B and C in bf16
    with chunk, head dim P and state N each in :data:`TC_DIMS`,
    ``"cuda_cores"`` otherwise."""
    bf16 = x_dtype == torch.bfloat16 and bc_dtype == torch.bfloat16
    return "tensor_cores" if bf16 and all(d in TC_DIMS for d in (chunk, p, n)) else "cuda_cores"


def cc_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory (bytes) of one CUDA-core block at chunk Q, head-dim
    columns P and state N: B and C (Q rows of N + 1), x·dt (Q × P), a C·Bᵀ
    tile (RT × (Q + 1)), h (P rows of N + 1) and four (Q,) vectors, in f32.
    The same sum as ``cc::smem_floats`` in ``csrc/ssd.cu`` (the library's
    ``ssd_smem_bytes``)."""
    return 4 * (2 * chunk * (n + 1) + chunk * p + CC_RT * (chunk + 1) + p * (n + 1) + 4 * chunk)


def cc_p_block(chunk: int, p: int, n: int) -> int:
    """The head-dim columns one CUDA-core block takes: all P where the
    instance fits :data:`SMEM_LIMIT`, else P halved (rounded up) until it
    does. The blocks of one (head, batch row) split P; no sum changes
    order, so the outputs are those of the whole instance bit for bit."""
    pb = p
    while cc_smem_bytes(chunk, pb, n) > SMEM_LIMIT and pb > 1:
        pb = -(-pb // 2)
    return pb


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.ssd_launch.argtypes = [vp] * 7 + [ci] * 10 + [vp]
    lib.ssd_launch.restype = ci
    lib.ssd_tc_launch.argtypes = [vp] * 7 + [ll] + [ci] * 7 + [vp]
    lib.ssd_tc_launch.restype = ci
    lib.ssd_wgmma_tile.argtypes = [vp] * 9
    lib.ssd_wgmma_tile.restype = ci
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


def kernel_reads(t: torch.Tensor) -> bool:
    """Whether the tensor-core route reads this bf16 tensor (x (B, S, H, P),
    or B or C (B, S, N) or (B, S, G, N)) in place: the last dim contiguous, the base and
    every other stride of a dim of size > 1 a positive multiple of 16 bytes
    (TMA's rule). The model's slices of one projection qualify."""
    item = t.element_size()
    if t.data_ptr() % 16 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return False
    return all(t.shape[d] == 1 or (t.stride(d) > 0 and t.stride(d) * item % 16 == 0)
               for d in range(t.dim() - 1))


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of every dim but the last; a dim of size 1 gets one
    16-byte vector (any stride serves at index 0)."""
    return tuple(t.stride(d) if t.shape[d] > 1 else 16 // t.element_size() for d in range(t.dim() - 1))


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.ssd_error_string(err).decode()} ({err})")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, chunk: int, p_block: Optional[int] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: x (B, S, H, P) float32 or
    bfloat16, dt (B, S, H) and a (H,) float32, b_mat and c_mat (B, S, N) or
    (B, S, G, N) with G dividing H, float32 or bfloat16, on one CUDA device; ``chunk`` ≤ 128 divides S, and
    P, N ≤ 128. On the tensor-core route (:func:`route`) x, B, C and dt may
    be strided views (:func:`kernel_reads`); on the CUDA-core route every
    input is contiguous, and ``p_block`` (default :func:`cc_p_block`) sets
    the head-dim columns a block takes. Returns (y (B, S, H, P) in x's dtype, contiguous,
    h_final (B, H, P, N) float32). Raises if an argument is off or the
    launch fails; never synchronises."""
    if x.dim() != 4:
        raise ValueError(f"ssd_cuda: x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b_mat.dim() == 3:  # one group: the (B, S, 1, N) view
        b_mat, c_mat = b_mat.unsqueeze(2), c_mat.unsqueeze(2)
    g, n = b_mat.shape[2], b_mat.shape[-1]
    if g <= 0 or h % g:
        raise ValueError(f"ssd_cuda: {g} SSM groups must divide the {h} heads")
    which = route(x.dtype, b_mat.dtype, chunk, p, n)
    want = {"dt": (bsz, s, h), "a": (h,), "b_mat": (bsz, s, g, n), "c_mat": (bsz, s, g, n)}
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if which == "tensor_cores" and name in ("x", "b_mat", "c_mat"):
            if not kernel_reads(t):
                raise ValueError(f"{name}: strides {tuple(t.stride())} at {t.data_ptr() % 16} bytes past "
                                 "16-byte alignment: the last dim must be contiguous, the data and every "
                                 "other stride 16-byte aligned")
        elif which == "cuda_cores" or name == "a":
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
    pb = cc_p_block(chunk, p, n) if p_block is None else p_block
    if which == "cuda_cores" and not (0 < pb <= p and cc_smem_bytes(chunk, pb, n) <= SMEM_LIMIT):
        raise ValueError(f"ssd_cuda: p_block {pb} must be in 1..{p} and fit {SMEM_LIMIT} bytes")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, h_final
    lib = _LIB.get()
    stream = stream_handle(x.get_device())
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), h_final.data_ptr())
    if which == "tensor_cores":
        strides = (ctypes.c_longlong * 12)(*(_strides(x) + _strides(b_mat) + _strides(c_mat)
                                             + tuple(dt.stride())))
        err = lib.ssd_tc_launch(*ptrs, strides, bsz, s, h, g, p, n, chunk, stream)
    else:
        err = lib.ssd_launch(*ptrs, DTYPES[x.dtype], DTYPES[b_mat.dtype], bsz, s, h, g, p, n, chunk, pb,
                             stream)
    if err != 0:
        smem = f", {lib.ssd_smem_bytes(chunk, pb, n)} bytes of shared memory" if which == "cuda_cores" else ""
        _check(lib, err, f"ssd kernel launch ({which}{smem})")
    ssd_cuda.launches += 1
    launches_by_route[which] += 1
    return y, h_final


ssd_cuda.launches = 0  # kernel launches since the last reset, both routes


def reset_launches() -> None:
    """Zero the launch count and the per-route counts."""
    ssd_cuda.launches = 0
    for key in launches_by_route:
        launches_by_route[key] = 0


def wgmma_tile(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor, h: torch.Tensor) -> tuple:
    """One wgmma tile of each of the tensor-core route's products, loaded by
    the same TMA maps and read through the same descriptors and fragments:
    c, b (64, 128) and x (64, 64) contiguous bf16, h (64, 128) f32, on the
    card. Returns (c bᵀ (64, 64), c hᵀ (64, 64) with h as its hi + lo
    pair, s x (64, 64) with s = c bᵀ as a hi + lo pair, xᵀ b (64, 128)), all
    f32; for checking the swizzle and the descriptors against a plain matrix
    product. Not a launch of the scan: counts nothing."""
    for name, t, shape, dtype in (("c", c, (64, 128), torch.bfloat16), ("b", b, (64, 128), torch.bfloat16),
                                  ("x", x, (64, 64), torch.bfloat16), ("h", h, (64, 128), torch.float32)):
        if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} {dtype} CUDA tensor")
    outs = [torch.empty(shape, dtype=torch.float32, device=c.device)
            for shape in ((64, 64), (64, 64), (64, 64), (64, 128))]
    lib = _LIB.get()
    err = lib.ssd_wgmma_tile(c.data_ptr(), b.data_ptr(), x.data_ptr(), h.data_ptr(),
                             *(o.data_ptr() for o in outs), stream_handle(c.get_device()))
    _check(lib, err, "ssd wgmma tile launch")
    return tuple(outs)
