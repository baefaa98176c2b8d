"""Stage-1 database (paper §3.1): software characteristics + hardware PPA.

The paper populates this from perf/AccelSeeker/HPVM profiles and CACTI; none of
those are available offline, so we ship a parametric library with the same
*shape*: per-(task, mapping) performance entries (GPP ops/s, accelerator
A_peak), per-block power/area entries over the Table-3 knob ladders, and the
Table-1 Gables workload profiles. Energy/area constants are order-of-magnitude
figures for a ~5 nm class process (documented in DESIGN.md as stand-ins).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

from .blocks import Block, BlockKind


def _stable_unit(name: str) -> float:
    """Deterministic pseudo-random in [0,1) from a task name (used to give
    every task a stable accelerator speedup without an RNG)."""
    h = hashlib.sha256(name.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    gpp_pj_per_op: float = 15.0  # fetch/decode overhead dominates (paper §1)
    acc_pj_per_op: float = 0.25  # hardened datapath, 5 nm-class MAC
    dram_pj_per_byte: float = 15.0
    sram_pj_per_byte: float = 1.0
    noc_pj_per_byte_hop: float = 0.8
    # static leakage, W per block (scaled by freq for PEs)
    gpp_leak_w: float = 2e-3
    acc_leak_w: float = 5e-4
    mem_leak_w_per_mb: float = 2e-3
    noc_leak_w: float = 5e-4


@dataclasses.dataclass(frozen=True)
class AreaModel:
    gpp_mm2: float = 1.2
    acc_mm2: float = 0.35
    sram_mm2_per_mb: float = 0.45
    dram_phy_mm2: float = 0.6
    noc_mm2_per_byte_width: float = 0.004


class HardwareDatabase:
    """PPA estimates queried by the simulator and the explorer."""

    def __init__(
        self,
        gpp_ops_per_cycle: float = 2.0,
        a_peak_range: tuple = (8.0, 64.0),
        energy: EnergyModel = EnergyModel(),
        area: AreaModel = AreaModel(),
        sram_capacity_mb: float = 4.0,
    ) -> None:
        self.gpp_ops_per_cycle = gpp_ops_per_cycle
        self.a_peak_range = a_peak_range
        self.energy = energy
        self.area = area
        self.sram_capacity_mb = sram_capacity_mb
        self._apeak_cache: Dict[str, float] = {}

    # ---- performance ----------------------------------------------------
    def pe_peak_ops(self, block: Block) -> float:
        """P_peak_CPU for GPPs; accelerators are priced via ``a_peak`` (Eq. 2)."""
        return block.freq_mhz * 1e6 * self.gpp_ops_per_cycle

    def a_peak_base(self, task_name: str) -> float:
        """Per-task hardened-datapath speedup at unroll=1 (AccelSeeker-style
        entry; deterministic per task so results are reproducible)."""
        if task_name not in self._apeak_cache:
            lo, hi = self.a_peak_range
            self._apeak_cache[task_name] = lo + (hi - lo) * _stable_unit(task_name)
        return self._apeak_cache[task_name]

    def a_peak(self, task_name: str, llp: float = 1.0, unroll: int = 1) -> float:
        """Eq. 2's A_peak. Loop unrolling (Table 3 swap knob) multiplies the
        datapath speedup but is capped by the task's loop-level parallelism —
        this is how the explorer's customization move *exploits LLP* (§5.4)."""
        return self.a_peak_base(task_name) * max(1.0, min(float(unroll), llp))

    # ---- power ------------------------------------------------------------
    def compute_energy_pj(self, block: Block, ops: float) -> float:
        per = self.energy.acc_pj_per_op if block.subtype == "acc" else self.energy.gpp_pj_per_op
        return per * ops

    def mem_energy_pj(self, block: Block, nbytes: float) -> float:
        per = self.energy.sram_pj_per_byte if block.subtype == "sram" else self.energy.dram_pj_per_byte
        return per * nbytes

    def noc_energy_pj(self, nbytes_hops: float) -> float:
        return self.energy.noc_pj_per_byte_hop * nbytes_hops

    def leakage_w(self, block: Block) -> float:
        f_scale = block.freq_mhz / 400.0
        if block.kind == BlockKind.PE:
            base = self.energy.acc_leak_w if block.subtype == "acc" else self.energy.gpp_leak_w
            return base * f_scale
        if block.kind == BlockKind.MEM:
            cap = self.sram_capacity_mb if block.subtype == "sram" else 0.5
            return self.energy.mem_leak_w_per_mb * cap * f_scale
        return self.energy.noc_leak_w * block.n_links * f_scale

    # ---- area ---------------------------------------------------------------
    def block_area_mm2(self, block: Block) -> float:
        f_scale = 0.6 + 0.4 * (block.freq_mhz / 800.0)  # freq costs area (timing closure)
        if block.kind == BlockKind.PE:
            base = self.area.acc_mm2 if block.subtype == "acc" else self.area.gpp_mm2
            return base * f_scale
        if block.kind == BlockKind.MEM:
            if block.subtype == "sram":
                return self.area.sram_mm2_per_mb * self.sram_capacity_mb * f_scale
            return self.area.dram_phy_mm2
        return self.area.noc_mm2_per_byte_width * block.width_bytes * block.n_links * f_scale
