"""The three AR workloads (paper §2.2–2.3, Fig. 2, Table 1).

TDG structures follow the paper's description: Audio has 15 tasks and the
highest task-level parallelism; CAVA is a serial ISP pipeline (TaLP = 1);
Edge Detection has 6 tasks, modest TaLP (4) and the highest LLP / data
movement. Per-task Gables numbers are spread deterministically around the
Table-1 per-task averages (the paper's appendix task tables are not in the
text) so that every Table-1 average is matched exactly.

Budgets: Table 4a gives 21/34/34 ms latencies with 8.737 mW / 17.475 mm²
system budgets at 5 nm. Those power numbers are not reachable under *any*
physical pJ/op constant given Table 1's own op counts (CAVA alone runs
~170 Gops per 34 ms frame → ≥1 W at 5 nm-class 0.3 pJ/op; the paper's internal
AccelSeeker database evidently counts "ops" differently). We therefore keep
the paper's latency budgets and latency *ratios*, and calibrate power/area
budgets against our own database (``calibrated_budget``) so that convergence
experiments are demanding but feasible — see EXPERIMENTS.md §Deviations.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Dict, List, Optional

from .budgets import Budget
from .database import HardwareDatabase
from .tdg import Task, TaskGraph, merge_graphs

MOPS = 1e6
MB = 1e6


def _spread(center: float, names: List[str], lo: float = 0.5, hi: float = 1.5) -> Dict[str, float]:
    """Deterministic per-task factors in [lo, hi], rescaled to preserve the
    mean exactly (Table-1 values are per-task averages)."""
    raw = {}
    for n in names:
        h = int.from_bytes(hashlib.sha256(n.encode()).digest()[:8], "big") / 2**64
        raw[n] = lo + (hi - lo) * h
    mean = sum(raw.values()) / len(raw)
    return {n: center * v / mean for n, v in raw.items()}


def audio() -> TaskGraph:
    """Audio decoder: pose-driven soundfield rotation/zoom + speaker mapping.
    15 tasks: source-decode → 8 parallel ambisonic channel encoders → combine
    → 4 parallel band rotate/zoom stages → binaural mix (high TaLP)."""
    g = TaskGraph("audio")
    names = (
        ["src_decode"]
        + [f"enc_ch{i}" for i in range(8)]
        + ["combine"]
        + [f"rotzoom_b{i}" for i in range(4)]
        + ["binaural_mix"]
    )
    f = _spread(13 * MOPS, names)
    llp = _spread(2392.0, names)
    for n in names:
        g.add_task(
            Task(n, work_ops=f[n], i_read=8.0, i_write=12.0, llp=llp[n], burst_bytes=256)
        )
    edge = 0.19 * MB  # Table-1 average data movement per task
    for i in range(8):
        g.add_edge("src_decode", f"enc_ch{i}", edge)
        g.add_edge(f"enc_ch{i}", "combine", edge)
    for i in range(4):
        g.add_edge("combine", f"rotzoom_b{i}", edge)
        g.add_edge(f"rotzoom_b{i}", "binaural_mix", edge)
    g.validate()
    return g


def cava() -> TaskGraph:
    """CAVA camera-vision ISP pipeline (Nikon-D7000-modelled kernel): a strict
    serial chain — TaLP = 1, only loop-level parallelism (Table 1)."""
    g = TaskGraph("cava")
    names = ["scale", "demosaic", "denoise", "wbalance", "cspace", "gamut", "tonemap"]
    f = _spread(24_252 * MOPS, names)
    llp = _spread(151.0, names)
    for n in names:
        g.add_task(
            Task(n, work_ops=f[n], i_read=67e3, i_write=74e3, llp=llp[n], burst_bytes=1024)
        )
    for a, b in zip(names, names[1:]):
        g.add_edge(a, b, 0.33 * MB)
    g.validate()
    return g


def edge_detection() -> TaskGraph:
    """Edge detection: 6 tasks, gradient operators run in parallel (TaLP = 4),
    massive LLP (per-pixel independence) and the highest data movement."""
    g = TaskGraph("ed")
    names = ["grayscale", "gauss_blur", "grad_x", "grad_y", "laplacian", "magnitude"]
    f = _spread(1_098 * MOPS, names)
    llp = _spread(1_365_376.0, names)
    for n in names:
        g.add_task(
            Task(n, work_ops=f[n], i_read=126.0, i_write=1.23e6, llp=llp[n], burst_bytes=4096)
        )
    g.add_edge("grayscale", "gauss_blur", 7.01 * MB)
    for n in ("grad_x", "grad_y", "laplacian"):
        g.add_edge("gauss_blur", n, 7.01 * MB)
        g.add_edge(n, "magnitude", 7.01 * MB)
    g.validate()
    return g


def all_workloads() -> Dict[str, TaskGraph]:
    return {"audio": audio(), "cava": cava(), "ed": edge_detection()}


def ar_complex() -> TaskGraph:
    """The §5 SoC scenario: all three workloads running together."""
    return merge_graphs(all_workloads().values(), name="ar_complex")


PAPER_LATENCY_S = {"audio": 21e-3, "cava": 34e-3, "ed": 34e-3}


def paper_budget() -> Budget:
    """Table 4a verbatim (see module docstring for why power/area are not
    directly usable with our stand-in database)."""
    return Budget(latency_s=dict(PAPER_LATENCY_S), power_w=8.737e-3, area_mm2=17.475)


def ideal_latency_s(g: TaskGraph, db: HardwareDatabase) -> float:
    """Critical-path latency with every task on its own maxed accelerator and
    infinite bandwidth — the analytic floor used for budget calibration."""
    best: Dict[str, float] = {}
    for name, t in g.tasks.items():
        p = db.gpp_ops_per_cycle * 800e6 * db.a_peak(name, t.llp, 1024)
        best[name] = t.work_ops / p

    memo: Dict[str, float] = {}

    def finish(n: str) -> float:
        if n not in memo:
            memo[n] = best[n] + max((finish(p) for p in g.parents[n]), default=0.0)
        return memo[n]

    return max(finish(n) for n in g.tasks)


def _power_area_rails(
    graphs, db: HardwareDatabase, lat_s: float,
    power_slack: float, area_slack: float,
):
    """Shared power/area budget rails: best-case dynamic energy
    (all-accelerator, all-SRAM) spread over ``lat_s`` plus a base leakage,
    and one hardened IP per task + modest NoC/Mem overhead. Used by both
    `calibrated_budget` (paper workloads) and `synthetic_budget` (generated
    scenarios) so the floor model stays in one place."""
    e_floor = 0.0
    n_tasks = 0
    for g in graphs:
        for t in g.tasks.values():
            e_floor += t.work_ops * db.energy.acc_pj_per_op * 1e-12
            e_floor += t.data_bytes * db.energy.sram_pj_per_byte * 1e-12
            n_tasks += 1
    base_leak_w = n_tasks * db.energy.acc_leak_w + 10e-3
    power = power_slack * (e_floor / lat_s + base_leak_w)
    area = area_slack * (
        n_tasks * db.area.acc_mm2 + 2 * db.area.dram_phy_mm2 + 2.0
    )
    return power, area


def calibrated_budget(
    db: HardwareDatabase,
    latency_slack: float = 8.0,
    power_slack: float = 1.2,
    area_slack: float = 1.15,
) -> Budget:
    """Budgets derived from analytic floors × slack so they are demanding but
    feasible under our stand-in PPA database (see module docstring):

      latency — per-workload critical-path floor × slack (at least the
                paper's Table-4a value, preserving the 21:34:34 ratio)
      power   — best-case dynamic energy (all-accelerator, all-SRAM) spread
                over the slowest latency budget, plus a base leakage
      area    — one hardened IP per task + modest NoC/Mem overhead
    """
    lats = {}
    for name, g in all_workloads().items():
        floor = ideal_latency_s(g, db)
        lats[name] = max(PAPER_LATENCY_S[name], floor * latency_slack)

    power, area = _power_area_rails(
        all_workloads().values(), db, max(lats.values()), power_slack, area_slack
    )
    return Budget(latency_s=lats, power_w=power, area_mm2=area)


# ---------------------------------------------------------------------------
# generative scenario family (policy × scenario sweeps)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    """One synthetic exploration scenario: a generated TDG plus a budget
    calibrated against that graph's own analytic floors, ready to drop into
    a ``Campaign`` run grid."""

    name: str
    tdg: TaskGraph
    budget: Budget


# archetype envelopes bracketing the three AR workloads (Table 1): op count
# per task, operational intensities, LLP, burst, and edge data movement
_ARCHETYPES = {
    # audio-like: small tasks, wide fan-out, modest data movement
    "audio": dict(ops=(5, 40), i_rd=(4.0, 16.0), i_wr=(6.0, 24.0),
                  llp=(500.0, 5000.0), burst=256, edge_mb=(0.05, 0.4)),
    # cava-like: op-heavy serial stages, very high intensity
    "cava": dict(ops=(5_000, 40_000), i_rd=(30e3, 120e3), i_wr=(40e3, 140e3),
                 llp=(50.0, 400.0), burst=1024, edge_mb=(0.1, 0.6)),
    # ed-like: write-dominated, massive LLP, heavy data movement
    "ed": dict(ops=(300, 3_000), i_rd=(60.0, 300.0), i_wr=(0.5e6, 3e6),
               llp=(2e5, 3e6), burst=4096, edge_mb=(2.0, 10.0)),
}


def synthetic_budget(
    g: TaskGraph,
    db: HardwareDatabase,
    speedup_target: float = 8.0,
    power_slack: float = 1.4,
    area_slack: float = 1.2,
) -> Budget:
    """`calibrated_budget` for a single generated graph — demanding but
    feasible, so iterations-to-budget is a meaningful cross-policy metric on
    every scenario.

    The latency budget is calibrated against a *simulation of the base
    design* (everything on one GPP + one DRAM): budget = base latency /
    ``speedup_target``. The fully-idealized analytic floor
    (`ideal_latency_s`) is useless here — high-LLP archetypes put it 3–4
    orders of magnitude below anything a bounded search reaches, which
    would turn every scenario into a censored non-convergence. A base-
    relative target instead demands real optimization (hardening, forking,
    memory re-mapping) that an architecture-aware policy finds in tens of
    iterations. Power/area keep the analytic-floor × slack calibration of
    `calibrated_budget` (they are the non-binding guard rails)."""
    from .design import Design
    from .phase_sim import simulate

    base = simulate(Design.base(g), g, db)
    lat = base.latency_s / speedup_target
    power, area = _power_area_rails([g], db, lat, power_slack, area_slack)
    return Budget(latency_s={g.name: lat}, power_w=power, area_mm2=area)


def synthetic_family(
    seed: int = 0,
    n: int = 6,
    db: Optional[HardwareDatabase] = None,
    min_tasks: int = 6,
    max_tasks: int = 16,
    speedup_target: float = 8.0,
) -> List[Scenario]:
    """Generate ``n`` randomized AR-like TDG scenarios (+ calibrated budgets).

    Each scenario is built stage-wise from the structural motifs of the
    paper's workloads — serial **chains** (CAVA), **fan-outs** into parallel
    stages (Audio's channel encoders, ED's gradient operators), and
    **merges** back into a combiner — with per-task Gables characteristics
    drawn from one of three archetype envelopes bracketing Table 1, jittered
    per task. Graphs are DAGs by construction (edges only flow from the open
    frontier to newly minted tasks) and every graph closes on a single sink,
    so ``validate()`` holds for any (seed, n).

    Budgets come from :func:`synthetic_budget`: base-design-relative latency
    targets plus analytic-floor power/area rails — demanding but feasible,
    so iterations-to-budget is a meaningful cross-policy comparison on every
    scenario. Deterministic in ``seed``: scenario *i* only consumes scenario
    *i*'s sub-rng."""
    db = db or HardwareDatabase()
    out: List[Scenario] = []
    for i in range(n):
        rng = random.Random((seed << 16) ^ (0x5EED + i))
        arch = _ARCHETYPES[rng.choice(sorted(_ARCHETYPES))]
        name = f"syn{seed}_{i}"
        g = TaskGraph(name)
        n_tasks = rng.randint(min_tasks, max_tasks)

        def mk_task(tag: str) -> str:
            ops = rng.uniform(*arch["ops"]) * MOPS
            t = Task(
                tag,
                work_ops=ops,
                i_read=rng.uniform(*arch["i_rd"]),
                i_write=rng.uniform(*arch["i_wr"]),
                llp=rng.uniform(*arch["llp"]),
                burst_bytes=arch["burst"],
            )
            g.add_task(t)
            return tag

        def edge(a: str, b: str) -> None:
            g.add_edge(a, b, rng.uniform(*arch["edge_mb"]) * MB)

        frontier = [mk_task("t0_src")]
        k = 1
        while k < n_tasks - 1:
            motif = rng.choices(
                ("chain", "fanout", "merge"), weights=(3, 3, 2)
            )[0]
            if motif == "fanout" and k + 2 <= n_tasks - 1:
                src = rng.choice(frontier)
                width = min(rng.randint(2, 4), n_tasks - 1 - k)
                kids = [mk_task(f"t{k + j}_fan") for j in range(width)]
                for c in kids:
                    edge(src, c)
                frontier.remove(src)
                frontier.extend(kids)
                k += width
            elif motif == "merge" and len(frontier) >= 2:
                m = rng.randint(2, len(frontier))
                srcs = rng.sample(frontier, m)
                t = mk_task(f"t{k}_merge")
                for s in srcs:
                    edge(s, t)
                frontier = [f for f in frontier if f not in srcs] + [t]
                k += 1
            else:  # chain
                src = rng.choice(frontier)
                t = mk_task(f"t{k}_chain")
                edge(src, t)
                frontier[frontier.index(src)] = t
                k += 1
        sink = mk_task(f"t{k}_sink")
        for s in frontier:
            edge(s, sink)
        g.validate()
        out.append(
            Scenario(name, g, synthetic_budget(g, db, speedup_target=speedup_target))
        )
    return out
