"""Phase-driven simulation (paper §3.2, Fig. 4; Eqs. 5–6).

A *phase* is the longest time quantum within which the system bottleneck stays
constant. Because rates only change when a task is scheduled in or out, the
simulator: (1) schedules every dependency-satisfied task (first-ready-first-
served — the paper's only scheduling policy), (2) prices every running task's
rates with the extended-Gables models, (3) advances the clock by the minimum
completion time (Eq. 6), (4) retires finished tasks and loops.

Each task carries three work components (compute ops, read bytes, write bytes)
that drain *concurrently* at their component rates — Eq. 5's ``max`` is the
completion condition. The event-driven reference (`event_sim.py`) instead
serializes per-burst, which is what bounds this model's fidelity (§4: buses
show the highest error because intra-phase congestion is assumed constant).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .database import HardwareDatabase
from .design import Design
from .gables import RouteContext, binding_block, bottleneck_of, phase_rates
from .ppa import mem_capacities, total_area_mm2, total_leakage_w
from .tdg import TaskGraph, workload_of

_EPS = 1e-12


@dataclasses.dataclass
class SimResult:
    latency_s: float
    workload_latency_s: Dict[str, float]
    energy_j: float
    power_w: float
    area_mm2: float
    n_phases: int
    # time-weighted seconds each resource class was the binding bottleneck
    bottleneck_s: Dict[str, float]
    # per-task binding resource at completion (drives Algorithm-1 selection)
    task_bottleneck: Dict[str, str]
    task_finish_s: Dict[str, float]
    mem_capacity_bytes: Dict[str, float]
    # concrete bottleneck block instance per task + per-task dynamic energy
    task_bottleneck_block: Dict[str, str] = dataclasses.field(default_factory=dict)
    task_energy_j: Dict[str, float] = dataclasses.field(default_factory=dict)
    # bottleneck_s resolved to concrete block instances: seconds each block
    # was the binding bottleneck of some running task (Σ over blocks of one
    # kind == bottleneck_s[kind]). This is the host reference the device-side
    # telemetry columns (pe_bneck_s / mem_bneck_s) are validated against.
    block_bottleneck_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Fig-16 system dynamics: time-weighted avg of concurrently-busy PEs
    # (accelerator-level parallelism, Hill & Reddi ALP) and total bytes moved
    avg_accel_parallelism: float = 1.0
    total_traffic_bytes: float = 0.0

    def metric(self, name: str) -> float:
        return {
            "latency": self.latency_s,
            "power": self.power_w,
            "area": self.area_mm2,
        }[name]


@dataclasses.dataclass
class _TaskState:
    ops: float
    rd: float
    wr: float

    def done(self) -> bool:
        return self.ops <= _EPS and self.rd <= _EPS and self.wr <= _EPS


def simulate(
    design: Design,
    tdg: TaskGraph,
    db: HardwareDatabase,
    max_phases: int = 100_000,
) -> SimResult:
    state: Dict[str, _TaskState] = {
        name: _TaskState(t.work_ops, t.read_bytes, t.write_bytes)
        for name, t in tdg.tasks.items()
    }
    completed: set = set()
    finish_s: Dict[str, float] = {}
    task_bneck: Dict[str, str] = {}
    task_bneck_block: Dict[str, str] = {}
    task_energy_pj: Dict[str, float] = {t: 0.0 for t in tdg.tasks}
    bneck_s: Dict[str, float] = {"pe": 0.0, "mem": 0.0, "noc": 0.0}
    block_bneck_s: Dict[str, float] = {b: 0.0 for b in design.blocks}
    energy_pj = 0.0
    now = 0.0
    n_phases = 0
    alp_time = 0.0
    traffic_bytes = 0.0
    ctx = RouteContext(design, tdg)

    while len(completed) < len(tdg.tasks):
        n_phases += 1
        if n_phases > max_phases:
            raise RuntimeError("phase-driven simulation did not terminate")
        running = [
            t
            for t in tdg.tasks
            if t not in completed and all(p in completed for p in tdg.parents[t])
        ]
        assert running, "deadlock: no ready task but graph incomplete"
        rates = phase_rates(design, tdg, running, db, ctx)

        # Eq. 5 on *remaining* work, Eq. 6 over running tasks
        remain: Dict[str, float] = {}
        for t in running:
            r, s = rates[t], state[t]
            remain[t] = max(
                s.ops / r.compute_ops_s, s.rd / r.read_bw, s.wr / r.write_bw
            )
        phi = min(remain.values())  # Eq. 6
        phi = max(phi, _EPS)

        # advance all components concurrently, accumulate energy
        for t in running:
            r, s = rates[t], state[t]
            d_ops = min(s.ops, r.compute_ops_s * phi)
            d_rd = min(s.rd, r.read_bw * phi)
            d_wr = min(s.wr, r.write_bw * phi)
            s.ops -= d_ops
            s.rd -= d_rd
            s.wr -= d_wr
            pe = design.blocks[design.task_pe[t]]
            mem = design.blocks[design.task_mem[t]]
            hops = ctx.hops[t]
            e = (
                db.compute_energy_pj(pe, d_ops)
                + db.mem_energy_pj(mem, d_rd + d_wr)
                + db.noc_energy_pj((d_rd + d_wr) * hops)
            )
            energy_pj += e
            task_energy_pj[t] += e
            kind = bottleneck_of(tdg.tasks[t], r)
            bneck_s[kind] += phi
            blk = binding_block(design, t, r, kind)
            block_bneck_s[blk] = block_bneck_s.get(blk, 0.0) + phi

        now += phi
        alp_time += len({design.task_pe[t] for t in running}) * phi
        traffic_bytes += sum(
            min(state[t].rd + state[t].wr, (rates[t].read_bw + rates[t].write_bw) * phi)
            for t in running
        )
        for t in running:
            if state[t].done() or remain[t] <= phi + _EPS:
                # numerical guard: a task whose Eq.-5 time equals phi retires
                state[t].ops = state[t].rd = state[t].wr = 0.0
                completed.add(t)
                finish_s[t] = now
                kind = bottleneck_of(tdg.tasks[t], rates[t])
                task_bneck[t] = kind
                task_bneck_block[t] = binding_block(design, t, rates[t], kind)

    # ---- PPA rollup -----------------------------------------------------
    energy_j = energy_pj * 1e-12 + total_leakage_w(design, db) * now
    power_w = energy_j / now if now > 0 else 0.0
    area = total_area_mm2(design, tdg, db)
    mem_cap = mem_capacities(design, tdg)

    wl_latency: Dict[str, float] = {}
    for t, f in finish_s.items():
        # un-namespaced tasks (single-workload graphs) roll up to the graph name
        w = workload_of(t) if "." in t else tdg.name
        wl_latency[w] = max(wl_latency.get(w, 0.0), f)

    return SimResult(
        latency_s=now,
        workload_latency_s=wl_latency,
        energy_j=energy_j,
        power_w=power_w,
        area_mm2=area,
        n_phases=n_phases,
        bottleneck_s=bneck_s,
        task_bottleneck=task_bneck,
        task_finish_s=finish_s,
        mem_capacity_bytes=mem_cap,
        task_bottleneck_block=task_bneck_block,
        task_energy_j={t: e * 1e-12 for t, e in task_energy_pj.items()},
        block_bottleneck_s=block_bneck_s,
        avg_accel_parallelism=alp_time / now if now > 0 else 1.0,
        total_traffic_bytes=traffic_bytes,
    )
