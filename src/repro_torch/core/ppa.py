"""Shared power/area rollup used by both simulators (paper §3.2 "Power/Area
Modeling": AccelSeeker-style IP estimates + CACTI-style memory/NoC estimates,
here served by the parametric database)."""
from __future__ import annotations

from typing import Dict

from .blocks import BlockKind
from .database import HardwareDatabase
from .design import Design
from .tdg import TaskGraph


def mem_capacities(design: Design, tdg: TaskGraph) -> Dict[str, float]:
    """Bytes resident per memory block: each task's output buffer lives on its
    mapped memory (conservative, no liveness analysis)."""
    cap = {m: 0.0 for m in design.mems()}
    for t, m in design.task_mem.items():
        cap[m] += tdg.tasks[t].write_bytes
    return cap


def total_area_mm2(design: Design, tdg: TaskGraph, db: HardwareDatabase) -> float:
    cap = mem_capacities(design, tdg)
    area = 0.0
    for b in design.blocks.values():
        if b.kind == BlockKind.MEM and b.subtype == "sram":
            area += db.area.sram_mm2_per_mb * max(cap[b.name], 1.0) / 1e6
        else:
            area += db.block_area_mm2(b)
    return area


def total_leakage_w(design: Design, db: HardwareDatabase) -> float:
    return sum(db.leakage_w(b) for b in design.blocks.values())
