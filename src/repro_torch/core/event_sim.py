"""Event-driven reference simulator — the Synopsys Platform Architect stand-in
(paper §4).

PA's "approximately timed" mode advances on *transactions* and fixed time
intervals. We model each task as a three-stage pipeline (read-burst → compute
→ write-burst) over its chunks, re-arbitrating contention at **every** stage-
completion event: this captures the intra-phase congestion transients that the
phase-driven model deliberately averages away (§4: "we do not model
intermittent congestion ... and rather assume constant congestion for a
phase"), which is exactly where the two simulators diverge.

Granularity is ``burst_bytes`` per transaction (the paper sets PA's interval
to 10 µs ≈ 1000–10000 block cycles); ``max_chunks`` caps event counts for very
fine bursts. Each transaction additionally pays a protocol *header*
(``NOC_HEADER_BYTES`` per burst per hop) — transaction-level overhead the
analytical Gables rates deliberately do not model, which is what gives the
phase simulator a real (small, burst-size-dependent) error against this
reference: small-burst, communication-heavy tasks err most, matching the
paper's observation that buses show the highest fidelity sensitivity (§4).
The phase simulator's accuracy/speedup numbers in EXPERIMENTS.md are measured
against this reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .database import HardwareDatabase
from .design import Design
from .gables import RouteContext
from .phase_sim import SimResult
from .ppa import mem_capacities, total_area_mm2, total_leakage_w
from .tdg import TaskGraph, workload_of

_EPS = 1e-12
_STAGES = ("read", "compute", "write")
NOC_HEADER_BYTES = 8.0  # per burst per transaction (protocol overhead)


@dataclasses.dataclass
class _PipeState:
    n_chunks: int
    per_chunk: Dict[str, float]  # work per chunk per stage
    done_chunks: Dict[str, int]
    stage_remaining: Dict[str, float]  # remaining work in the in-flight chunk

    @staticmethod
    def of(task, max_chunks: int) -> "_PipeState":
        n = int(max(1.0, min(task.read_bytes / max(task.burst_bytes, 1.0), max_chunks)))
        # transaction header: each burst carries protocol bytes the analytic
        # model ignores (scaled so the cap on n preserves total overhead)
        n_true = max(task.read_bytes / max(task.burst_bytes, 1.0), 1.0)
        hdr = NOC_HEADER_BYTES * n_true / n
        per = {
            "read": task.read_bytes / n + hdr,
            "compute": task.work_ops / n,
            "write": task.write_bytes / n + hdr,
        }
        return _PipeState(
            n_chunks=n,
            per_chunk=per,
            done_chunks={s: 0 for s in _STAGES},
            stage_remaining={s: 0.0 for s in _STAGES},
        )

    def stage_active(self, stage: str) -> bool:
        i = _STAGES.index(stage)
        if self.done_chunks[stage] >= self.n_chunks:
            return False
        if self.stage_remaining[stage] > _EPS:
            return True
        # can a new chunk enter this stage? (upstream must be ahead)
        if i == 0:
            return True
        return self.done_chunks[_STAGES[i - 1]] > self.done_chunks[stage]

    def ensure_inflight(self) -> None:
        for s in _STAGES:
            if self.stage_active(s) and self.stage_remaining[s] <= _EPS:
                self.stage_remaining[s] = self.per_chunk[s]

    def complete(self) -> bool:
        return all(self.done_chunks[s] >= self.n_chunks for s in _STAGES)


def _stage_rates(
    design: Design,
    tdg: TaskGraph,
    pipes: Dict[str, _PipeState],
    running: List[str],
    db: HardwareDatabase,
    ctx: RouteContext,
) -> Dict[str, Dict[str, float]]:
    """Rates for the *currently active* stage instances only — this is the
    transaction-level re-arbitration."""
    active = {
        t: [s for s in _STAGES if pipes[t].stage_active(s)] for t in running
    }
    # PE contention: equal share among tasks actively computing on the PE
    pe_users: Dict[str, int] = {}
    for t in running:
        if "compute" in active[t]:
            pe = design.task_pe[t]
            pe_users[pe] = pe_users.get(pe, 0) + 1
    # Mem contention per direction: burst-proportional among active users
    mem_burst: Dict[tuple, float] = {}
    for t in running:
        mem = design.task_mem[t]
        b = tdg.tasks[t].burst_bytes
        if "read" in active[t]:
            mem_burst[(mem, "read")] = mem_burst.get((mem, "read"), 0.0) + b
        if "write" in active[t]:
            mem_burst[(mem, "write")] = mem_burst.get((mem, "write"), 0.0) + b
    # NoC: striped links, burst-proportional within link, per direction
    noc_users: Dict[str, List[str]] = {}
    for t in sorted(running):
        for noc_name in ctx.route(t):
            noc_users.setdefault(noc_name, []).append(t)
    noc_link_burst: Dict[tuple, float] = {}
    link_of: Dict[tuple, int] = {}
    for noc_name, users in noc_users.items():
        n_links = design.blocks[noc_name].n_links
        for i, t in enumerate(users):
            link = i % n_links
            link_of[(t, noc_name)] = link
            b = tdg.tasks[t].burst_bytes
            for d in ("read", "write"):
                if d in active[t]:
                    key = (noc_name, link, d)
                    noc_link_burst[key] = noc_link_burst.get(key, 0.0) + b

    rates: Dict[str, Dict[str, float]] = {}
    for t in running:
        task = tdg.tasks[t]
        pe = design.blocks[design.task_pe[t]]
        mem = design.blocks[design.task_mem[t]]
        r: Dict[str, float] = {}
        if "compute" in active[t]:
            p = db.pe_peak_ops(pe) / pe_users[pe.name]
            if pe.subtype == "acc" and pe.hardened_for == t:
                p *= db.a_peak(t, task.llp, pe.unroll)
            r["compute"] = p
        for d in ("read", "write"):
            if d in active[t]:
                share = task.burst_bytes / mem_burst[(mem.name, d)]
                bw = mem.peak_bandwidth(db) * share
                for noc_name in ctx.route(t):
                    noc = design.blocks[noc_name]
                    link = link_of[(t, noc_name)]
                    tot = noc_link_burst[(noc_name, link, d)]
                    bw = min(bw, noc.peak_bandwidth(db) * (task.burst_bytes / tot))
                r[d] = bw
        rates[t] = r
    return rates


def simulate_events(
    design: Design,
    tdg: TaskGraph,
    db: HardwareDatabase,
    max_chunks: int = 256,
    max_events: int = 5_000_000,
) -> SimResult:
    pipes = {t: _PipeState.of(task, max_chunks) for t, task in tdg.tasks.items()}
    completed: set = set()
    finish_s: Dict[str, float] = {}
    energy_pj = 0.0
    now = 0.0
    n_events = 0
    bneck_s = {"pe": 0.0, "mem": 0.0, "noc": 0.0}
    ctx = RouteContext(design, tdg)

    while len(completed) < len(tdg.tasks):
        running = [
            t
            for t in tdg.tasks
            if t not in completed and all(p in completed for p in tdg.parents[t])
        ]
        assert running, "deadlock"
        for t in running:
            pipes[t].ensure_inflight()
        rates = _stage_rates(design, tdg, pipes, running, db, ctx)

        # next event = earliest in-flight stage completion
        dt = float("inf")
        for t in running:
            for s, rate in rates[t].items():
                rem = pipes[t].stage_remaining[s]
                if rem > _EPS and rate > 0:
                    dt = min(dt, rem / rate)
        assert dt < float("inf"), "no active stage"
        dt = max(dt, _EPS)
        n_events += 1
        if n_events > max_events:
            raise RuntimeError("event simulation exceeded max_events")

        for t in running:
            task = tdg.tasks[t]
            pe = design.blocks[design.task_pe[t]]
            mem = design.blocks[design.task_mem[t]]
            hops = ctx.hops[t]
            slowest, slow_s = 0.0, "pe"
            for s, rate in rates[t].items():
                rem = pipes[t].stage_remaining[s]
                if rem <= _EPS:
                    continue
                d = min(rem, rate * dt)
                pipes[t].stage_remaining[s] = rem - d
                if pipes[t].stage_remaining[s] <= _EPS * max(1.0, rem):
                    pipes[t].stage_remaining[s] = 0.0
                    pipes[t].done_chunks[s] += 1
                if s == "compute":
                    energy_pj += db.compute_energy_pj(pe, d)
                else:
                    energy_pj += db.mem_energy_pj(mem, d)
                    energy_pj += db.noc_energy_pj(d * hops)
                t_need = rem / rate
                if t_need > slowest:
                    slowest, slow_s = t_need, s
            bneck_s["pe" if slow_s == "compute" else "mem"] += dt

        now += dt
        for t in running:
            if pipes[t].complete():
                completed.add(t)
                finish_s[t] = now

    energy_j = energy_pj * 1e-12 + total_leakage_w(design, db) * now
    wl_latency: Dict[str, float] = {}
    for t, f in finish_s.items():
        w = workload_of(t) if "." in t else tdg.name
        wl_latency[w] = max(wl_latency.get(w, 0.0), f)
    return SimResult(
        latency_s=now,
        workload_latency_s=wl_latency,
        energy_j=energy_j,
        power_w=energy_j / now if now else 0.0,
        area_mm2=total_area_mm2(design, tdg, db),
        n_phases=n_events,
        bottleneck_s=bneck_s,
        task_bottleneck={},
        task_finish_s=finish_s,
        mem_capacity_bytes=mem_capacities(design, tdg),
    )
