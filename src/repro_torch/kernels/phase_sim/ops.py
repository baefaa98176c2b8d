"""Drop-in wrapper for the phase-sim kernel.

``phase_sim(enc, rows)`` accepts exactly what
``repro_torch.core.phase_sim_torch.simulate_batch`` accepts (an
:class:`EncodedWorkload` plus the per-design rows dict, as tensors on one
device) and returns the same output dict. The device of the rows picks the
path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.phase_sim_cuda``) or raise —
    there is no fallback to the plain version;
  * CPU tensors run the plain version (``ref.phase_sim_ref``) on the task
    axis padded the way the kernel pads its threads: T up to a multiple of
    32, padded tasks born completed;
  * any other device raises.

The wrapper owns the layout differences: it packs the four ``NOCS_COLS``
scalars into one ``(B, 4)`` input and unpacks the kernel's packed output
row (``SCAL_COLS``, per-slot telemetry, per-workload latency, finish times,
bottleneck codes). :func:`phase_sim_rows` returns that packed row block
itself — what the backend copies to the host in one transfer.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...core.phase_sim_torch import EncodedWorkload, phase_sim_plain
from ...core.scal_layout import KIND_START, KIND_STOP, SCAL_COLS, SCAL_PREFIX
from .kernel import NOCS_COLS, out_layout, padded_tasks, phase_sim_cuda

_F32 = torch.float32


def _dims(enc: EncodedWorkload, rows: Dict[str, torch.Tensor]):
    return (
        len(enc.names), rows["pe_peak"].shape[1], rows["mem_bw"].shape[1],
        rows["noc_bw"].shape[1], len(enc.wl_names),
    )


def pack_nocs(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The four per-candidate scalars as the kernel's ``(B, 4)`` input."""
    return torch.stack([rows[k].to(_F32) for k in NOCS_COLS], 1)


def pack_plain(out: Dict[str, torch.Tensor], t: int) -> torch.Tensor:
    """The plain version's output dict as the kernel's packed rows."""
    scal = torch.stack([out[k].to(_F32) for k in SCAL_PREFIX], 1)
    tops = torch.stack([out["top_bneck_pe"], out["top_bneck_mem"]], 1).to(_F32)
    return torch.cat(
        [scal, out["bneck_kind_s"], tops, out["pe_bneck_s"], out["mem_bneck_s"],
         out["noc_bneck_s"], out["wl_latency_s"], out["finish_s"][:, :t],
         out["bneck_code"][:, :t].contiguous().view(_F32)],
        1,
    )


def phase_sim_rows(  # repro_torch: hot
    enc: EncodedWorkload,
    rows: Dict[str, torch.Tensor],
    *,
    nocs: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Price ``rows`` and return the packed ``(B, width)`` result rows
    (:func:`~repro_torch.kernels.phase_sim.kernel.out_layout`). ``nocs`` may
    carry the ``(B, 4)`` scalars already packed; ``out`` a preallocated
    result buffer (CUDA only)."""
    dev = rows["task_pe"].device
    if any(v.device != dev for v in rows.values()):
        raise ValueError("phase_sim: rows span several devices")
    t = len(enc.names)
    if dev.type == "cuda":
        if nocs is None:
            nocs = pack_nocs(rows)
        if out is None:
            lay = out_layout(*_dims(enc, rows))
            out = torch.empty((rows["task_pe"].shape[0], lay["width"]), dtype=_F32, device=dev)
        return phase_sim_cuda(enc.on(dev), rows, nocs, out)
    if dev.type != "cpu":
        raise ValueError(f"phase_sim: no kernel for device {dev}")
    tp = padded_tasks(t)
    padded = dict(rows)
    for k, fill in (("task_pe", 0), ("task_mem", 0), ("pe_accel", 1.0)):
        padded[k] = F.pad(rows[k], (0, tp - t), value=fill)
    res = phase_sim_plain(enc.on(dev, pad_to=tp), padded, t)
    return pack_plain(res, t)


def unpack(packed: torch.Tensor, enc: EncodedWorkload, s_pe: int, s_mem: int,
           n_noc: int) -> Dict[str, torch.Tensor]:
    """Views of the packed result rows under ``simulate_batch``'s keys."""
    t, n_wl = len(enc.names), len(enc.wl_names)
    lay = out_layout(t, s_pe, s_mem, n_noc, n_wl)
    col = {name: packed[:, i] for i, name in enumerate(SCAL_COLS)}
    return {
        "latency_s": col["latency_s"],
        "finish_s": packed[:, lay["finish"]:lay["finish"] + t],
        "all_done": col["all_done"] > 0.5,
        "bneck_code": packed[:, lay["bneck"]:lay["bneck"] + t].view(torch.int32),
        "bneck_kind_s": packed[:, KIND_START:KIND_STOP],
        "pe_bneck_s": packed[:, lay["pe"]:lay["mem"]],
        "mem_bneck_s": packed[:, lay["mem"]:lay["noc"]],
        "noc_bneck_s": packed[:, lay["noc"]:lay["scal_end"]],
        "top_bneck_pe": col["top_bneck_pe"].to(torch.int32),
        "top_bneck_mem": col["top_bneck_mem"].to(torch.int32),
        "alp_time_s": col["alp_time_s"],
        "traffic_bytes": col["traffic_bytes"],
        "n_phases": col["n_phases"].to(torch.int32),
        "wl_latency_s": packed[:, lay["wl"]:lay["finish"]],
        "energy_j": col["energy_j"],
        "power_w": col["power_w"],
        "area_mm2": col["area_mm2"],
        "fitness": col["fitness"],
    }


def phase_sim(enc: EncodedWorkload,  # repro_torch: hot
              rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Kernel counterpart of ``simulate_batch`` (same contract)."""
    packed = phase_sim_rows(enc, rows)
    return unpack(packed, enc, rows["pe_peak"].shape[1], rows["mem_bw"].shape[1],
                  rows["noc_bw"].shape[1])
