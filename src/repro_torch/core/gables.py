"""Extended-Gables analytical models (paper §3.2, Eqs. 1–5).

Given the set of tasks *running in a phase* and their mappings, compute each
block's per-task processing rate and each task's completion time:

  Eq. 1  P_CPU  = P_peak_CPU / |T|                 (preemptive equal share)
  Eq. 2  P_IP   = A_peak · P_peak_CPU / |T|
  Eq. 3  B_NoC  = per-task share of link bandwidth, burst-ratio arbitrated
  Eq. 4  B_Mem  = B_peak_Mem · Burst_i / Σ_j Burst_j
  Eq. 5  C_T    = max(f/P, D_r/B_mem_r, D_w/B_mem_w, D/B_noc, ...)

Note on Eqs. 3/4: the paper's printed equations *divide* by the burst ratio,
which is dimensionally inverted (a task with a larger share would get *less*
bandwidth, and a lone task with ratio 1.0 would see exactly B_peak only by
accident). The prose — "this division is determined by the burst size ratio of
the task over the total bursts of all running tasks" — describes proportional
arbitration, which is what we implement: share_i = Burst_i / Σ Burst. For NoCs,
``n_links`` parallel channels serve disjoint task subsets (multi-channel
routers for master/slave combinations, §3.2): tasks are striped over links
round-robin and arbitrate within their link.

Reads and writes are split (I_read / I_write) because "modern routers/memories
support separate channels for each" — so read and write streams of one memory
do not contend with each other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .blocks import BlockKind
from .design import Design
from .database import HardwareDatabase
from .tdg import TaskGraph


@dataclasses.dataclass
class TaskRates:
    """Per-running-task processing rates for the current phase."""

    compute_ops_s: float
    read_bw: float  # bytes/s end-to-end for the read stream (min of path)
    write_bw: float
    # per-resource attribution for bottleneck analysis:
    binding: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the slowest NoC instance on the task's route (bottleneck-block targeting)
    noc_name: str = ""


class RouteContext:
    """Per-design route/topology cache. A design is immutable while being
    simulated; precomputing routes removes the O(tasks²·chain) rediscovery
    from every phase (the simulator hot path)."""

    def __init__(self, design: Design, tdg: TaskGraph):
        self.routes: Dict[str, tuple] = {t: tuple(design.route(t)) for t in tdg.tasks}
        self.hops: Dict[str, int] = {t: len(r) for t, r in self.routes.items()}

    def route(self, t: str) -> tuple:
        return self.routes[t]


def phase_rates(
    design: Design,
    tdg: TaskGraph,
    running: List[str],
    db: HardwareDatabase,
    ctx: RouteContext = None,
) -> Dict[str, TaskRates]:
    """Compute every running task's rates under current contention."""
    ctx = ctx or RouteContext(design, tdg)
    # --- Eq. 1/2: PE rates, preemptive equal sharing --------------------
    pe_load: Dict[str, int] = {}
    for t in running:
        pe_load[design.task_pe[t]] = pe_load.get(design.task_pe[t], 0) + 1

    # --- burst bookkeeping for Mem (Eq. 4) and NoC (Eq. 3) --------------
    mem_burst_read: Dict[str, float] = {}
    mem_burst_write: Dict[str, float] = {}
    # NoC link assignment: tasks using a NoC are striped over its links
    # round-robin (stable order), then burst-arbitrated within the link.
    noc_users: Dict[str, List[str]] = {}
    for t in sorted(running):
        for noc_name in ctx.route(t):
            noc_users.setdefault(noc_name, []).append(t)
    noc_link_tasks: Dict[tuple, List[str]] = {}
    link_of: Dict[tuple, int] = {}
    for noc_name, users in noc_users.items():
        n_links = design.blocks[noc_name].n_links
        for i, t in enumerate(users):
            link = i % n_links
            link_of[(t, noc_name)] = link
            noc_link_tasks.setdefault((noc_name, link), []).append(t)
    for t in sorted(running):
        task = tdg.tasks[t]
        mem = design.task_mem[t]
        mem_burst_read[mem] = mem_burst_read.get(mem, 0.0) + task.burst_bytes
        mem_burst_write[mem] = mem_burst_write.get(mem, 0.0) + task.burst_bytes

    out: Dict[str, TaskRates] = {}
    for t in running:
        task = tdg.tasks[t]
        pe = design.blocks[design.task_pe[t]]
        mem = design.blocks[design.task_mem[t]]
        n_on_pe = pe_load[pe.name]

        # Eq. 1 / Eq. 2
        p_peak = db.pe_peak_ops(pe)
        if pe.subtype == "acc":
            a = (
                db.a_peak(task.name, task.llp, pe.unroll)
                if pe.hardened_for == task.name
                else 1.0
            )
            compute = a * p_peak / n_on_pe
        else:
            compute = p_peak / n_on_pe

        # Eq. 4 (proportional burst arbitration; read/write channels separate)
        b_mem_peak = mem.peak_bandwidth(db)
        share_r = task.burst_bytes / mem_burst_read[mem.name]
        share_w = task.burst_bytes / mem_burst_write[mem.name]
        mem_read_bw = b_mem_peak * share_r
        mem_write_bw = b_mem_peak * share_w

        # Eq. 3: per-link arbitration along the route; end-to-end = min link
        noc_bw, slow_noc = float("inf"), ""
        for noc_name in ctx.route(t):
            noc = design.blocks[noc_name]
            peers = noc_link_tasks[(noc_name, link_of[(t, noc_name)])]
            total_burst = sum(tdg.tasks[p].burst_bytes for p in peers)
            share = task.burst_bytes / total_burst
            bw = noc.peak_bandwidth(db) * share
            if bw < noc_bw:
                noc_bw, slow_noc = bw, noc_name

        read_bw = min(mem_read_bw, noc_bw)
        write_bw = min(mem_write_bw, noc_bw)
        out[t] = TaskRates(
            compute_ops_s=compute,
            read_bw=read_bw,
            write_bw=write_bw,
            binding={
                "pe": compute,
                "mem_read": mem_read_bw,
                "mem_write": mem_write_bw,
                "noc": noc_bw,
            },
            noc_name=slow_noc,
        )
    return out


def binding_block(design: Design, t: str, rates: TaskRates, kind: str) -> str:
    """Resolve a bottleneck class to the concrete block instance to target."""
    if kind == "pe":
        return design.task_pe[t]
    if kind == "mem":
        return design.task_mem[t]
    return rates.noc_name or design.route(t)[0]


def completion_time(task, rates: TaskRates) -> float:
    """Eq. 5: the task finishes when its *slowest* component finishes."""
    return max(
        task.work_ops / rates.compute_ops_s,
        task.read_bytes / rates.read_bw,
        task.write_bytes / rates.write_bw,
    )


def bottleneck_of(task, rates: TaskRates) -> str:
    """Which block class binds Eq. 5's max — drives Algorithm-1 reasoning and
    the Fig.-12 comm/comp boundedness characterization."""
    comp = task.work_ops / rates.compute_ops_s
    rd = task.read_bytes / rates.read_bw
    wr = task.write_bytes / rates.write_bw
    if comp >= rd and comp >= wr:
        return "pe"
    # communication-bound: memory or NoC, whichever is the tighter pipe
    mem_bw = rates.binding["mem_read"] if rd >= wr else rates.binding["mem_write"]
    return "mem" if mem_bw <= rates.binding["noc"] else "noc"
