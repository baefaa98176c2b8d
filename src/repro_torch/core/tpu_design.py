"""FARSI on the pod: the paper's simulator + explorer applied to the
distributed-execution design space; the port's copy of the reference's
``repro.core.tpu_design``. It prices a step on a modelled TPU v5e pod on
the host (``core/phase_sim.simulate``), as the reference does; nothing here
runs on the card, and none of its times is a time of the port.

*Workload*: one training/serving step, as a TDG whose tasks are the step-graph
ops (roofline/analytic.py per-device costs). Compute ops carry FLOPs as Gables
work `f` and HBM traffic as `D`; collectives become communication-only tasks
whose bytes ride the ICI "NoC".

*Design*: one representative TPU chip (SPMD symmetry) — a PE at the modelled
chip's bf16 peak, an HBM "memory" (1024 B × 800 MHz), and an ICI "NoC"
(64 B × 800 MHz) — priced through the same Block/Database interfaces as the
SoC designs, with ladder knobs intact.

*Estimate*: the phase-driven simulator runs the step TDG with Eqs. 1–6 —
giving a step-time estimate that models compute/HBM/ICI *overlap* through
task-level parallelism, where the bare 3-term roofline only gives
max(t_c, t_h, t_i). The autotuner (launch/autotune.py) uses this as its agile
cost oracle.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..roofline.analytic import (
    TPU_V5E_PEAK_FLOPS,
    MeshShape,
    OpCost,
    roofline_terms,
    step_costs,
)
from ..sharding.rules import DistConfig
from .blocks import Block, BlockKind
from .database import TPUDatabase
from .design import Design
from .phase_sim import SimResult, simulate
from .tdg import Task, TaskGraph


class PodDatabase(TPUDatabase):
    """TPU constants expressed through the HardwareDatabase interface."""

    def pe_peak_ops(self, block: Block) -> float:
        return TPU_V5E_PEAK_FLOPS


def step_tdg(ops: List[OpCost]) -> TaskGraph:
    """Step-graph ops → FARSI TDG. A compute op's communication component is
    its HBM traffic (split evenly read/write for I_read/I_write); a
    collective op is all-communication routed over the ICI NoC (expressed as
    a task whose 'memory' is the remote pod — its D rides the NoC route)."""
    g = TaskGraph("tpu_step")
    for op in ops:
        if op.ici_bytes > 0 and op.flops == 0:
            # communication-only task: tiny compute, bytes over ICI
            g.add_task(
                Task(
                    op.name,
                    work_ops=1.0,
                    i_read=1.0 / max(op.ici_bytes / 2, 1e-9),
                    i_write=1.0 / max(op.ici_bytes / 2, 1e-9),
                    llp=1.0,
                    burst_bytes=65536,
                )
            )
        else:
            rd = max(op.hbm_bytes / 2, 1.0)
            wr = max(op.hbm_bytes / 2, 1.0)
            g.add_task(
                Task(
                    op.name,
                    work_ops=max(op.flops, 1.0),
                    i_read=max(op.flops, 1.0) / rd,
                    i_write=max(op.flops, 1.0) / wr,
                    llp=1e6,  # matrix-unit ops are fully data-parallel
                    burst_bytes=65536,
                )
            )
    for op in ops:
        for dep in op.deps:
            if dep in g.tasks:
                g.add_edge(dep, op.name, 0.0)
    g.validate()
    return g


def pod_design(g: TaskGraph, db: PodDatabase) -> Design:
    """One chip + HBM + ICI. Compute tasks map to (chip, HBM); collective
    tasks map their 'buffer' to the ICI-attached remote memory so their
    traffic rides the NoC chain (multi-hop = inter-pod)."""
    d = Design()
    ici = d.add_block(
        Block(kind=BlockKind.NOC, subtype="noc", freq_mhz=800, width_bytes=64, n_links=1)
    )
    hbm_noc = d.add_block(
        Block(kind=BlockKind.NOC, subtype="noc", freq_mhz=800, width_bytes=1024, n_links=4)
    )
    chip = d.add_block(
        Block(kind=BlockKind.PE, subtype="acc", freq_mhz=800, hardened_for=None),
        attach_to=hbm_noc.name,
    )
    hbm = d.add_block(
        Block(kind=BlockKind.MEM, subtype="dram", freq_mhz=800, width_bytes=1024),
        attach_to=hbm_noc.name,
    )
    # the remote endpoint must never be the binding pipe — the ICI NoC is the
    # collective bandwidth model (so link-schedule knobs act on the NoC)
    remote = d.add_block(
        Block(kind=BlockKind.MEM, subtype="dram", freq_mhz=800, width_bytes=1024),
        attach_to=ici.name,
    )
    collective_markers = ("_tp", "a2a", "sync")
    for t in g.tasks:
        d.task_pe[t] = chip.name
        is_coll = any(m in t for m in collective_markers)
        d.task_mem[t] = remote.name if is_coll else hbm.name
    return d


def simulate_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: MeshShape,
    dist: Optional[DistConfig] = None,
) -> Dict[str, float]:
    """FARSI phase-sim step-time estimate + the three roofline terms."""
    ops = step_costs(cfg, shape, mesh, dist)
    links = dist.ici_links if dist else 1
    terms = roofline_terms(ops, ici_links=links)
    g = step_tdg(ops)
    db = PodDatabase()
    design = pod_design(g, db)
    # a multi-direction ring serves a SINGLE collective with all links —
    # model as wider ICI (n_links stripes *different* tasks, not this)
    ici = design.blocks[design.noc_chain[0]]
    ici.width_bytes = ici.width_bytes * links
    res: SimResult = simulate(design, g, db)
    terms["t_phase_sim_s"] = res.latency_s
    terms["sim_bottleneck_s"] = dict(res.bottleneck_s)
    # overlap efficiency: roofline max() vs dependency-aware estimate
    terms["overlap_ratio"] = (
        terms["t_roofline_s"] / res.latency_s if res.latency_s > 0 else 1.0
    )
    return terms
