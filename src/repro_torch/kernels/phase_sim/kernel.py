"""CUDA phase-sim kernel for Hopper: build, bind and launch.

The kernel (``csrc/phase_sim.cu``) replaces the Pallas TPU kernel
``_phase_sim_kernel`` of ``src/repro/kernels/phase_sim/kernel.py``. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
entry point, at first use, into ``build/kernels/`` (``kernels._build``), and
bound with ``ctypes``. Nothing here runs at import: this module imports
cleanly on a machine with no CUDA toolkit.

One launch prices a whole batch: grid = B candidates, one thread per task
(T padded up to a multiple of 32). The kernel writes ONE packed f32 row per
candidate (:func:`out_layout`): the ``(B, 14 + S_pe + S_mem + N)`` scal block
in ``core.scal_layout`` order, then the per-workload latencies, the finish
times and the bottleneck codes (int32 bits), so a dispatch's results cross
to the host in one copy.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ...core.scal_layout import N_SCAL
from .._build import Library

# per-candidate scalars packed into one (B, 4) input, in this order
NOCS_COLS = ("noc_pj", "power_budget", "area_budget", "alpha")
N_NOCS = len(NOCS_COLS)
WARP = 32
MAX_TASKS = 1024  # one thread per task, one block per candidate
MAX_NOC = 8

SOURCE = Path(__file__).resolve().parent / "csrc" / "phase_sim.cu"
# IEEE division and denormals, and no contraction of a*b+c into one fused
# multiply-add: the bottleneck codes and the retire test are comparisons, and
# one ulp flips them, so every product and sum rounds as the plain version's
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def padded_tasks(t: int) -> int:
    """Threads per block: the task count rounded up to whole warps."""
    return max(WARP, -(-t // WARP) * WARP)


def out_layout(t: int, s_pe: int, s_mem: int, n_noc: int, n_wl: int) -> Dict[str, int]:
    """Column offsets of the kernel's packed output row."""
    pe = N_SCAL
    mem = pe + s_pe
    noc = mem + s_mem
    wl = noc + n_noc
    fin = wl + n_wl
    bn = fin + t
    return {"pe": pe, "mem": mem, "noc": noc, "scal_end": wl, "wl": wl,
            "finish": fin, "bneck": bn, "width": bn + t}


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phase_sim_launch.argtypes = [vp] * 29 + [vp, ci] + [ci] * 7 + [vp]
    lib.phase_sim_launch.restype = ci
    lib.phase_sim_error_string.argtypes = [ci]
    lib.phase_sim_error_string.restype = ctypes.c_char_p


_LIB = Library("phase_sim", SOURCE, NVCC_FLAGS, _bind)


def build() -> Path:
    """Compile the kernel library if this source/flag combination has not
    been built yet; returns its path and sets :data:`build_log`."""
    global build_log
    path = _LIB.build()
    build_log = _LIB.log
    return path


_F32_ROWS = (
    "pe_accel", "pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_active",
    "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb",
    "mem_active", "noc_bw", "noc_leak", "noc_area", "noc_active", "wl_budget",
)
_I32_ROWS = ("task_pe", "task_mem", "pe_noc", "mem_noc", "noc_links")


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def phase_sim_cuda(w, rows: Dict[str, torch.Tensor], nocs: torch.Tensor,
                   out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: ``w`` is the workload's
    (unpadded) :class:`~repro_torch.core.phase_sim_torch.WorkloadTensors`,
    ``rows`` the per-candidate tensors (``ROW_KEYS`` layout), ``nocs`` the
    packed ``(B, 4)`` scalars, ``out`` the ``(B, width)`` f32 result rows.
    Raises if an argument is off or the launch fails; never synchronises."""
    b, t = rows["task_pe"].shape
    s_pe = rows["pe_peak"].shape[1]
    s_mem = rows["mem_bw"].shape[1]
    n_noc = rows["noc_bw"].shape[1]
    n_wl = rows["wl_budget"].shape[1]
    if t > MAX_TASKS:
        raise ValueError(f"{t} tasks exceed the kernel's {MAX_TASKS} (one thread per task)")
    if n_noc > MAX_NOC:
        raise ValueError(f"{n_noc} NoCs exceed the kernel's {MAX_NOC}")
    f32, i32 = torch.float32, torch.int32
    for k in ("work_ops", "read_bytes", "write_bytes", "burst"):
        _check(k, getattr(w, k), f32, (t,))
    _check("parent_u8", w.parent_u8, torch.uint8, (t, t))
    _check("wl_id", w.wl_id, i32, (t,))
    widths = {"task_pe": t, "task_mem": t, "pe_accel": t, "wl_budget": n_wl,
              "noc_bw": n_noc, "noc_links": n_noc, "noc_leak": n_noc,
              "noc_area": n_noc, "noc_active": n_noc}
    for k in _F32_ROWS + _I32_ROWS:
        width = widths.get(k, s_pe if k.startswith("pe_") else s_mem)
        _check(k, rows[k], f32 if k in _F32_ROWS else i32, (b, width))
    _check("nocs", nocs, f32, (b, N_NOCS))
    lay = out_layout(t, s_pe, s_mem, n_noc, n_wl)
    _check("out", out, f32, (b, lay["width"]))
    if b == 0:
        return out
    lib = _LIB.get()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.phase_sim_launch(
        ptr(w.work_ops), ptr(w.read_bytes), ptr(w.write_bytes), ptr(w.burst),
        ptr(w.parent_u8), ptr(w.wl_id),
        ptr(rows["task_pe"]), ptr(rows["task_mem"]), ptr(rows["pe_accel"]),
        ptr(rows["pe_peak"]), ptr(rows["pe_pj"]), ptr(rows["pe_leak"]),
        ptr(rows["pe_area"]), ptr(rows["pe_noc"]), ptr(rows["pe_active"]),
        ptr(rows["mem_bw"]), ptr(rows["mem_pj"]), ptr(rows["mem_leak"]),
        ptr(rows["mem_area_fixed"]), ptr(rows["mem_area_per_mb"]),
        ptr(rows["mem_noc"]), ptr(rows["mem_active"]),
        ptr(rows["noc_bw"]), ptr(rows["noc_links"]), ptr(rows["noc_leak"]),
        ptr(rows["noc_area"]), ptr(rows["noc_active"]),
        ptr(nocs), ptr(rows["wl_budget"]),
        ptr(out), lay["width"],
        b, t, s_pe, s_mem, n_noc, n_wl, padded_tasks(t),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = lib.phase_sim_error_string(err).decode()
        raise RuntimeError(f"phase_sim kernel launch failed: {msg} ({err})")
    phase_sim_cuda.launches += 1
    return out


phase_sim_cuda.launches = 0  # kernel launches since the last reset
