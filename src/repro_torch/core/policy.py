"""Pluggable heuristic policies (paper §3.3–3.4, Algorithm 1, §5.2–5.3).

FARSI's headline result is not the simulator but the *navigation heuristic*:
simulated annealing augmented with architectural reasoning converges up to
16X faster than naive SA (§5.2), and co-design focus rotation adds another
32% (§5.3). This module makes that reasoning an explicit, swappable layer:
a :class:`HeuristicPolicy` owns the per-iteration 5-tuple selection
(metric → task → block → moves), the SA accept rule, the taboo list, and
the co-design ledger — the `Explorer` is reduced to the dispatch loop that
drives whichever policy `ExplorerConfig.policy` names.

Policies select from a :class:`~repro_torch.core.backend.SimTelemetry` view —
device-side bottleneck telemetry columns (per-block binding-bottleneck
seconds, top-bottleneck block, comp-vs-comm split) plus host-exact scalar
accessors — so a policy-driven search never forces the winner's full
``SimResult`` decode.

Registered policies (``POLICIES`` / ``make_policy``):

  ``naive_sa``    — every choice uniformly random (the §5.2 baseline; also
                    what ``awareness="sa"`` maps to)
  ``task``        — + bottleneck-driven task selection (awareness ladder)
  ``task_block``  — + bottleneck-driven block selection (awareness ladder)
  ``bottleneck``  — relaxation guided purely by the DEVICE telemetry: the
                    comp-vs-comm split picks the resource class, the
                    top-bottleneck column picks the block, the longest
                    hosted task is targeted; moves stay random
  ``locality``    — Algorithm-1 parallelism/locality move reasoning on top
                    of bottleneck-driven selection, without development-cost
                    precedence or co-design rotation
  ``farsi``       — the full composition (bottleneck relaxation + locality
                    exploitation + dev-cost precedence + co-design focus
                    rotation): replays the recorded golden accepted-move
                    sequences bit-for-bit under a fixed seed (fixtures are
                    regenerated only on deliberate behaviour changes —
                    tests/gen_golden_policy_seqs.py)
  ``dev_cost``    — ``farsi`` plus an explicit development-cost penalty on
                    every candidate's fitness (component count + variation,
                    NoCs double-weighted): the §5.3 NoC-simplification
                    policy, compared against ``farsi`` via the complexity
                    metrics ``Campaign.aggregate`` reports
  ``device_sa``   — ``naive_sa`` on the host path, and the DEVICE-ELIGIBLE
                    policy for the fused chain blocks
                    (the device chain block, a later slice of this package): its checkpoint/restore
                    additionally round-trips the chain-population carry
                    bit-exactly, so a crash-restarted session resumes
                    mid-population

A policy is stateful (taboo list, sticky focus, ledger) and must support
``checkpoint()``/``restore()`` so the serve layer can rebuild a crashed
session from its last committed state; the rng is the *explorer's* —
shared so the accept-draw/selection interleaving is reproducible from a
seed alone.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from .backend import SimTelemetry
from .blocks import BlockKind
from .budgets import Budget, Distance
from .codesign import CodesignLedger, FocusRecord
from .database import HardwareDatabase
from .design import Design
from .moves import MOVE_KINDS, MOVE_PRECEDENCE
from .tdg import TaskGraph, workload_of


def copy_carry(carry: Optional[tuple]) -> Optional[tuple]:
    """Deep-copy a chain-block carry (a tuple of host arrays) so policy
    checkpoints round-trip bit-exactly even if the live carry advances.
    Preserves the carry's tuple type."""
    if carry is None:
        return None
    return type(carry)(*(np.array(x, copy=True) for x in carry))


@dataclasses.dataclass(frozen=True)
class Focus:
    """One iteration's selection target: the (metric, task, block) triple of
    Algorithm 1 plus the task's binding-resource class."""

    metric: str
    task: str
    block: str
    bneck: str  # "pe" | "mem" | "noc"


@runtime_checkable
class HeuristicPolicy(Protocol):
    """The navigation heuristic the Explorer delegates to."""

    name: str
    needs_result: bool  # True → feed decoded SimResults instead of telemetry
    ledger: CodesignLedger

    def bind(self, tdg: TaskGraph, db: HardwareDatabase, budget: Budget,
             cfg, rng: random.Random) -> None:
        """Attach the search context. Called once by the Explorer."""
        ...

    def tick(self) -> None:
        """Start-of-iteration bookkeeping (taboo decay)."""
        ...

    def select_focus(self, design: Design, dist: Distance,
                     view: SimTelemetry) -> Focus:
        """Pick the next (metric, task, block, bneck) from the current
        design, its Eq.-7 distance, and the bottleneck telemetry."""
        ...

    def propose_moves(self, design: Design, focus: Focus) -> List[str]:
        """Ordered move kinds to try for ``focus`` (Algorithm 1 steps I–III)."""
        ...

    def accept(self, it: int, d_before: float, d_after: float, u: float) -> bool:
        """The SA accept rule on the device fitness column (``u`` is the
        pre-drawn uniform, one per resolved iteration — the same draw
        discipline the device accept loop mirrors in f32)."""
        ...

    def record(self, rec: FocusRecord) -> None:
        """Log one committed iteration's focus into the co-design ledger."""
        ...

    def mark_failed(self, task: str, block: str) -> None:
        """Taboo a (task, block) target that produced no acceptable move."""
        ...

    def is_taboo_task(self, task: str) -> bool:
        ...

    def move_penalty(self, design: Design, cand) -> float:
        """Additive fitness penalty for one priced candidate (Eq.-7 units).
        The explorer ranks and accept-tests on ``fitness + penalty``, so a
        non-zero penalty makes a candidate win only when its PPA gain
        outweighs its development cost. The default is 0.0 — bit-neutral."""
        ...

    def checkpoint(self) -> object:
        """Snapshot mutable policy state (crash restart / session resume)."""
        ...

    def restore(self, ck: object) -> None:
        ...


# ---------------------------------------------------------------------------
# shared structural predicates (Algorithm 1's parallelism/locality tests)
# ---------------------------------------------------------------------------
def block_has_parallel_tasks(design: Design, tdg: TaskGraph, block: str) -> bool:
    """Does ``block`` host two tasks that could run concurrently? Runs on the
    memoized ``tdg.parallel_set_of`` frozensets — no per-call set builds."""
    kind = design.blocks[block].kind
    if kind == BlockKind.PE:
        hosted = design.tasks_on_pe(block)
    elif kind == BlockKind.MEM:
        hosted = design.buffers_on_mem(block)
    else:
        hosted = design.tasks_via_noc(block)
    for i, a in enumerate(hosted):
        if tdg.parallel_set_of(a).intersection(hosted[i + 1:]):
            return True
    return False


def task_parallel_other_blocks(design: Design, tdg: TaskGraph, t: str) -> bool:
    """Does ``t`` have a concurrent peer mapped to a different PE?"""
    mine = design.task_pe[t]
    return any(design.task_pe[p] != mine for p in tdg.parallel_set_of(t))


# ---------------------------------------------------------------------------
# base: shared state + SA accept rule
# ---------------------------------------------------------------------------
class PolicyBase:
    """Common policy state: taboo list, sticky focus, co-design ledger, and
    the classic SA temperature accept test. Subclasses implement the
    selection reasoning."""

    name = "base"
    needs_result = False
    # the on-device move menu this policy corresponds to when the explorer
    # runs chain-batched (device_explore.MENUS). Any policy can carry the
    # chain-population state between blocks (``device_carry``), and every
    # checkpoint round-trips it bit-exactly; subclasses with a device-
    # eligible selection heuristic override the menu name.
    device_menu = "naive_sa"

    def __init__(self) -> None:
        self.ledger = CodesignLedger()
        self._taboo: Dict[Tuple[str, str], int] = {}
        self._sticky: Optional[str] = None  # codesign-off focus fixation
        self.device_carry: Optional[tuple] = None

    def bind(self, tdg, db, budget, cfg, rng) -> None:
        self.tdg = tdg
        self.db = db
        self.budget = budget
        self.cfg = cfg
        self.rng = rng

    # ---- bookkeeping -----------------------------------------------------
    def tick(self) -> None:
        self._taboo = {k: v - 1 for k, v in self._taboo.items() if v > 1}

    def mark_failed(self, task: str, block: str) -> None:
        self._taboo[(task, block)] = self.cfg.taboo_ttl

    def is_taboo_task(self, task: str) -> bool:
        return any(k[0] == task for k in self._taboo)

    def record(self, rec: FocusRecord) -> None:
        self.ledger.log(rec)

    def checkpoint(self) -> object:
        return (dict(self._taboo), self._sticky, copy_carry(self.device_carry))

    def restore(self, ck: object) -> None:
        self._taboo, self._sticky = dict(ck[0]), ck[1]
        self.device_carry = copy_carry(ck[2]) if len(ck) > 2 else None

    def move_penalty(self, design: Design, cand) -> float:
        """Development-cost scoring hook — 0.0 for every stock policy, so
        ranking and accept stay bit-identical to the raw fitness column
        (x + 0.0 is exact). :class:`DevCostPolicy` overrides it."""
        return 0.0

    # ---- SA accept (Eq.-7 fitness on the device column) ------------------
    def accept(self, it: int, d_before: float, d_after: float, u: float) -> bool:
        temp = self.cfg.temperature0 * self.cfg.temp_decay ** it
        return d_after < d_before or (
            temp > 0 and u < math.exp(-(d_after - d_before) / max(temp, 1e-9))
        )

    # ---- shared selection fragments --------------------------------------
    rotate = True  # False → always fixate, regardless of cfg.codesign

    def _metric_farthest(self, dist: Distance) -> str:
        """Focus rotation: re-pick the farthest metric every iteration when
        co-design is on (§5.3); fixate on one unmet metric when it is off
        (the paper's ablation) or when the policy opts out of rotation
        (``rotate = False`` — the locality ablation)."""
        if not self.cfg.codesign or not self.rotate:
            if self._sticky and dist.per_metric[self._sticky] > 0:
                return self._sticky
            unmet = [m for m, d in dist.per_metric.items() if d > 0]
            self._sticky = unmet[0] if unmet else "latency"
            return self._sticky
        return dist.farthest_metric()

    def _rank_tasks(self, design: Design, metric: str, dist: Distance,
                    view: SimTelemetry) -> List[str]:
        """Distance-contribution ranking per metric (§3.3): critical-path
        duration for latency (worst workload first), dynamic energy for
        power, resident memory footprint for area."""
        tasks = list(self.tdg.tasks)
        if metric == "latency":
            wl = max(
                dist.per_workload_latency,
                key=lambda w: dist.per_workload_latency[w],
            )
            pool = [t for t in tasks if workload_of(t) == wl] or tasks
            return sorted(pool, key=view.task_duration, reverse=True)
        if metric == "power":
            return sorted(tasks, key=view.task_energy_j, reverse=True)
        # area: tasks whose buffers sit on the largest memories first
        # (capacity is keyed by *memory* name — resolve through the task's
        # mapped memory; own write bytes break ties within one memory)
        return sorted(
            tasks,
            key=lambda t: (
                view.mem_capacity(design.task_mem.get(t, "")),
                self.tdg.tasks[t].write_bytes,
            ),
            reverse=True,
        )

    def _first_untabooed(self, ranked: List[str]) -> str:
        for t in ranked:
            if not self.is_taboo_task(t):
                return t
        return ranked[0]

    def _idle_block(self, design: Design) -> Optional[str]:
        """Dead hardware first: an idle block is pure leakage/area, and join
        removes it for free (the cheapest possible move)."""
        for n, b in design.blocks.items():
            if b.kind == BlockKind.PE and not design.tasks_on_pe(n):
                return n
            if b.kind == BlockKind.MEM and not design.buffers_on_mem(n):
                return n
        return None

    def _algorithm1_moves(self, design: Design, focus: Focus) -> List[str]:
        """Algorithm 1 step I: the move classes the parallelism/locality
        structure of the focus admits."""
        if focus.metric == "latency":
            if block_has_parallel_tasks(design, self.tdg, focus.block):
                return ["migrate", "fork"]
            return ["swap", "fork_swap"]
        if focus.metric == "power":
            if task_parallel_other_blocks(design, self.tdg, focus.task):
                if not block_has_parallel_tasks(design, self.tdg, focus.block):
                    return ["migrate"]
                return ["join"]
            return ["swap", "fork_swap"]
        # area
        if design.blocks[focus.block].kind == BlockKind.PE:
            return ["join", "swap"]
        return ["migrate", "join", "swap"]

    def _weighted_order(self, allowed: List[str], weights: List[float]) -> List[str]:
        """Algorithm 1 steps II/III: precedence-weighted probabilistic
        ordering, then graceful fallback to the rest of the move set."""
        ordered: List[str] = []
        pool, w = list(allowed), list(weights)
        while pool:
            pick = self.rng.choices(range(len(pool)), weights=w)[0]
            ordered.append(pool.pop(pick))
            w.pop(pick)
        ordered += [m for m in MOVE_KINDS if m not in ordered]
        return ordered


# ---------------------------------------------------------------------------
# the awareness ladder (paper Fig. 9b) as concrete policies
# ---------------------------------------------------------------------------
class NaiveSA(PolicyBase):
    """Pure simulated annealing: metric, task, block, and move order all
    uniformly random (the §5.2 baseline FARSI beats by up to 16X)."""

    name = "naive_sa"

    def select_focus(self, design, dist, view) -> Focus:
        metric = self.rng.choice(("latency", "power", "area"))
        task = self.rng.choice(list(self.tdg.tasks))
        block = self.rng.choice(list(design.blocks))
        return Focus(metric, task, block, view.task_bneck(task))

    def propose_moves(self, design, focus) -> List[str]:
        moves = list(MOVE_KINDS)
        self.rng.shuffle(moves)
        return moves


class DeviceSA(NaiveSA):
    """`naive_sa` + device-eligibility: the policy the fused chain blocks
    (the device chain block, a later slice of this package) run under. On the host path it behaves
    exactly like ``naive_sa`` (same draws, same accept rule); when the
    explorer runs chain-batched (``ExplorerConfig.chain_r > 0``) the device
    carry — per-chain task maps, fitness, PRNG keys, taboo TTLs, telemetry
    columns — is stored here between blocks, and ``checkpoint``/``restore``
    round-trip it bit-exactly so a crash-restarted session resumes
    mid-population instead of re-annealing from scratch.

    ``device_menu`` names the on-device move menu the policy corresponds
    to: ``naive_sa`` samples the packed move table uniformly — the menu the
    R=1/K=1 parity contract is stated against. (The carry storage and its
    bit-exact checkpoint round-trip live on :class:`PolicyBase` now, so
    every policy can drive chain blocks; this class survives as the
    canonical registry name for the uniform-menu device search.)"""

    name = "device_sa"
    device_menu = "naive_sa"


class TaskAware(NaiveSA):
    """+ bottleneck-driven task selection (awareness level ``task``)."""

    name = "task"

    def select_focus(self, design, dist, view) -> Focus:
        metric = self._metric_farthest(dist)
        task = self._first_untabooed(self._rank_tasks(design, metric, dist, view))
        block = self.rng.choice(list(design.blocks))
        return Focus(metric, task, block, view.task_bneck(task))


class TaskBlockAware(TaskAware):
    """+ bottleneck-driven block selection (awareness level ``task_block``)."""

    name = "task_block"

    def _select_block(self, design, metric, task, view) -> str:
        if metric in ("power", "area"):
            idle = self._idle_block(design)
            if idle is not None:
                return idle
        if metric == "area":
            return max(
                design.blocks,
                key=lambda b: self.db.block_area_mm2(design.blocks[b]),
            )
        blk = view.task_bneck_block(task)
        if blk in design.blocks:
            return blk
        return design.task_pe[task]

    def select_focus(self, design, dist, view) -> Focus:
        metric = self._metric_farthest(dist)
        task = self._first_untabooed(self._rank_tasks(design, metric, dist, view))
        block = self._select_block(design, metric, task, view)
        return Focus(metric, task, block, view.task_bneck(task))


class FarsiPolicy(TaskBlockAware):
    """The full FARSI heuristic: bottleneck relaxation + Algorithm-1
    locality reasoning + development-cost move precedence + co-design focus
    rotation. Replays the recorded golden accepted-move sequences
    bit-for-bit under a fixed seed (tests/test_policy.py fixtures;
    regenerated via tests/gen_golden_policy_seqs.py only when search
    behaviour changes deliberately).

    Device-eligible: the ``farsi`` chain menu weights the packed move table
    by bottleneck telemetry AND folds in the Algorithm-1 move-kind
    precedence (join > migrate ≈ attach > fork > swap) — the on-device
    counterpart of ``propose_moves``'s dev-cost-weighted ordering."""

    name = "farsi"
    device_menu = "farsi"

    def propose_moves(self, design, focus) -> List[str]:
        allowed = self._algorithm1_moves(design, focus)
        if self.cfg.dev_cost_aware:
            weights = [float(MOVE_PRECEDENCE[m]) for m in allowed]
        else:
            weights = [1.0] * len(allowed)
        return self._weighted_order(allowed, weights)


# ---------------------------------------------------------------------------
# telemetry-native policies (select straight from the device columns)
# ---------------------------------------------------------------------------
class BottleneckRelaxation(PolicyBase):
    """Pure bottleneck relaxation, driven by the device telemetry columns:
    the comp-vs-comm split picks the resource class to relax, the
    top-bottleneck column picks the block, and the longest task hosted on it
    is targeted. Move order stays random — this isolates *where to aim* (the
    telemetry's contribution) from *what to do* (Algorithm 1, see
    :class:`LocalityExploitation` / :class:`FarsiPolicy`).

    Device-eligible: the ``telemetry`` chain menu is this policy's
    on-device counterpart — move rows are weighted by the bottleneck
    seconds of their focus slot, straight from the carry's telemetry
    columns."""

    name = "bottleneck"
    device_menu = "telemetry"

    def select_focus(self, design, dist, view) -> Focus:
        metric = self._metric_farthest(dist)
        if metric == "area":
            idle = self._idle_block(design)
            block = idle or max(
                design.blocks,
                key=lambda b: self.db.block_area_mm2(design.blocks[b]),
            )
        elif view.comp_s >= view.comm_s:
            block = view.top_bneck_pe() or design.noc_chain[0]
        else:
            block = view.top_bneck_mem() or design.noc_chain[0]
        kind = design.blocks[block].kind
        if kind == BlockKind.PE:
            hosted = design.tasks_on_pe(block)
        elif kind == BlockKind.MEM:
            hosted = design.buffers_on_mem(block)
        else:
            hosted = list(self.tdg.tasks)
        pool = [t for t in hosted if not self.is_taboo_task(t)] or hosted \
            or list(self.tdg.tasks)
        task = max(pool, key=view.task_duration)
        return Focus(metric, task, block, view.task_bneck(task))

    def propose_moves(self, design, focus) -> List[str]:
        moves = list(MOVE_KINDS)
        self.rng.shuffle(moves)
        return moves


class LocalityExploitation(TaskBlockAware):
    """Algorithm-1 parallelism/locality move reasoning on top of
    bottleneck-driven selection, but WITHOUT development-cost precedence or
    co-design rotation: the structural reasoning alone, for ablating how
    much of FARSI's gain comes from *which move* vs *which target*."""

    name = "locality"
    rotate = False  # fixate until the focused metric meets budget

    def propose_moves(self, design, focus) -> List[str]:
        allowed = self._algorithm1_moves(design, focus)
        return self._weighted_order(allowed, [1.0] * len(allowed))


class DevCostPolicy(FarsiPolicy):
    """Development-cost-aware navigation (paper §5.3): FARSI's full
    heuristic plus an explicit component-count / variation penalty on every
    candidate's fitness. A move that grows the system (fork, fork_swap) or
    makes it more heterogeneous must buy a PPA improvement larger than its
    penalty to win a batch or pass the accept test; moves that simplify
    (join) are subsidised symmetrically. This is what lands the paper's
    NoC-simplification result: under equal budgets the dev_cost policy
    converges to designs with fewer and more uniform components —
    especially NoCs, whose forks are pure congestion relief and are easiest
    to over-provision — measured by ``Design.complexity_metrics`` and
    reported per policy by ``Campaign.aggregate``.

    The penalty is EXACT, not a proxy: the candidate's recorded move is
    replayed onto the base (checkpoint → metrics → rollback, O(blocks))
    and the complexity deltas are scored as
    ``lam_component · Δcomponents + lam_variation · Δvariation``, with NoC
    components double-weighted (``lam_noc`` rides on top of
    ``lam_component`` for them)."""

    name = "dev_cost"
    lam_component = 0.02  # Eq.-7 distance units per added block
    lam_noc = 0.04  # additional weight per added NoC (the §5.3 focus)
    lam_variation = 0.10  # per unit of mean heterogeneity-CV increase

    def move_penalty(self, design: Design, cand) -> float:
        if cand.spec is None:
            return 0.0
        delta = cand.delta
        if delta is not None and not (
            delta.added or delta.removed or delta.touched
        ):
            # pure mapping moves (migrate, join-less remaps) change no block
            # set and no knob — complexity is invariant, skip the replay.
            # Migrates dominate long anneals, so the exact-penalty path below
            # only runs for the few allocation/customization candidates.
            return 0.0
        before = design.complexity_metrics()
        with cand.materialized(self.tdg) as mutated:
            after = mutated.complexity_metrics()
        return (
            self.lam_component * (after["components"] - before["components"])
            + self.lam_noc * (after["noc_components"] - before["noc_components"])
            + self.lam_variation * (after["variation"] - before["variation"])
        )


POLICIES = {
    "naive_sa": NaiveSA,
    "device_sa": DeviceSA,
    "task": TaskAware,
    "task_block": TaskBlockAware,
    "bottleneck": BottleneckRelaxation,
    "locality": LocalityExploitation,
    "farsi": FarsiPolicy,
    "dev_cost": DevCostPolicy,
}

# awareness ladder → policy (ExplorerConfig.policy="" keeps the historical
# awareness knob working; both tests and benches sweep it)
AWARENESS_POLICY = {
    "sa": "naive_sa",
    "task": "task",
    "task_block": "task_block",
    "farsi": "farsi",
}


def make_policy(name: str) -> HeuristicPolicy:
    """Instantiate a registered policy by name (`ExplorerConfig.policy`)."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; known: {sorted(POLICIES)}"
        ) from None
    return cls()
