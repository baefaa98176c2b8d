"""Exploration engine (paper §3.3–3.4, Algorithm 1).

Simulated annealing is the base search; FARSI augments its neighbour
generation with architectural reasoning. A neighbour is produced by choosing
the 5-tuple (Metric, Direction, Task, Block, Move):

  metric    — the one farthest from budget (co-design: changes per iteration)
  direction — +1 buy performance / −1 return it
  task      — highest distance contribution (critical-path duration for
              latency, dynamic energy for power)
  block     — the task's bottleneck block (Eq. 5 attribution)
  move      — Algorithm 1 reasoning + development-cost precedence
              (join > migrate > fork > swap > fork_swap), sampled
              probabilistically by precedence weight

All of that reasoning lives in the pluggable **policy layer**
(`repro_torch.core.policy`): the Explorer owns the mechanics — neighbour
materialization and dispatch bookkeeping — and
delegates every selection and accept decision to the
:class:`~repro_torch.core.policy.HeuristicPolicy` named by
``ExplorerConfig.policy`` (default: derived from the historical
``awareness`` ladder — ``sa``/``task``/``task_block``/``farsi``, paper
Fig. 9b). Policies reason over :class:`~repro_torch.core.backend.SimTelemetry`
views fed from the device-side bottleneck telemetry columns, so the
winner's full ``SimResult`` decode is paid ONCE per exploration (for the
returned best design), not per accepted move.

If no neighbour improves, the failed (task, block) target goes on the
policy's short taboo list so the next iteration targets "the task/block
with the next highest distance" (§3.4), and classic SA temperature
occasionally accepts a worse design.

The host loop issues one dispatch + one round trip per iteration; on the
``torch`` backend each dispatch prices the iteration's neighbours with one
launch of the CUDA phase-sim kernel (its plain PyTorch version on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Generator, List, Optional

import random

from .backend import Candidate, SimHandle, SimTelemetry, SimulatorBackend, make_backend
from .budgets import Budget, Distance
from .codesign import CodesignLedger, FocusRecord
from .database import HardwareDatabase
from .design import Design
from .device_explore import (
    ChainBlockResult,
    ChainRequest,
    reconcile_alloc,
    reconcile_mapping,
)
from .moves import MoveDelta, MoveSpec, apply_move
from .phase_sim import SimResult
from .policy import AWARENESS_POLICY, Focus, HeuristicPolicy, make_policy
from .tdg import TaskGraph, workload_of

AWARENESS_LEVELS = ("sa", "task", "task_block", "farsi")


@dataclasses.dataclass
class _Sel:
    """One dispatched iteration's selection context (the focus and the
    candidates a resolution needs back after its batch was scored)."""

    it: int
    focus: Focus
    neighbors: List["Candidate"]


@dataclasses.dataclass
class ExplorerConfig:
    awareness: str = "farsi"
    # HeuristicPolicy registry name (policy.POLICIES). Empty string — the
    # default — derives the policy from ``awareness`` (sa → naive_sa, … ,
    # farsi → farsi) so the historical knob keeps working; naming a policy
    # explicitly overrides the ladder (e.g. "bottleneck", "locality").
    policy: str = ""
    neighbors_per_iter: int = 4
    max_iterations: int = 1500
    seed: int = 0
    temperature0: float = 0.05
    temp_decay: float = 0.997
    alpha_met: float = 0.05
    dev_cost_aware: bool = True
    codesign: bool = True  # False => fixate focus until the focused metric is met
    taboo_ttl: int = 5
    backend: str = "torch"  # SimulatorBackend registry name (backend.BACKENDS)
    # where the batched backend prices: the card unless the caller asks for
    # the CPU (where the kernel's plain PyTorch version runs)
    device: str = "cuda"
    # device-resident chain blocks (run_chains): chain_r > 0 opts the search
    # into the fused accept loop — R independent chains × K fused iterations
    # per dispatch. chain_menu picks the device move menu ("" derives it
    # from the policy's ``device_menu``; see device_explore.MENUS).
    chain_r: int = 0
    chain_k: int = 32
    chain_menu: str = ""
    # chain_alloc widens the device move table from mapping-only migrates to
    # the mixed mapping+allocation menu (PE/MEM fork/join/frequency-swap +
    # NoC attach over capacity-padded slot inventories). The whole run then
    # explores platform shape on device; the winning chain's platform is
    # reconciled onto the live design ONCE, after the last block
    # (device_explore.reconcile_alloc), so the seed encoding — which the
    # carry's fork provenance indexes — stays valid across blocks.
    chain_alloc: bool = False


@dataclasses.dataclass
class ExplorationResult:
    best_design: Design
    best_result: SimResult
    best_distance: Distance
    converged: bool
    iterations: int
    n_sims: int  # committed evaluations this search dispatched
    wall_s: float
    history: List[dict]
    ledger: CodesignLedger
    backend_name: str = "python"
    policy_name: str = "farsi"
    sim_wall_s: float = 0.0  # time inside backend.evaluate for this run
    chained: bool = False  # ran as device-resident (R, K) chain blocks
    chain_r: int = 0  # chain population size (chained runs only)

    def iterations_to_budget(self, cap: Optional[int] = None) -> float:
        """Iterations this run needed to reach budget — the policy-comparison
        metric (paper Fig. 9b): the iteration count when converged, else
        ``cap`` (default: the iterations actually run) as a censored floor."""
        if self.converged:
            return float(self.iterations)
        return float(cap if cap is not None else self.iterations)


class Explorer:
    def __init__(
        self,
        tdg: TaskGraph,
        db: HardwareDatabase,
        budget: Budget,
        config: ExplorerConfig = ExplorerConfig(),
        backend: Optional[SimulatorBackend] = None,
    ) -> None:
        self.tdg = tdg
        self.db = db
        self.budget = budget
        self.cfg = config
        assert config.awareness in AWARENESS_LEVELS
        self.rng = random.Random(config.seed)
        self.backend = backend or make_backend(
            config.backend, tdg, db, device=config.device
        )
        self.policy: HeuristicPolicy = make_policy(
            config.policy or AWARENESS_POLICY[config.awareness]
        )
        self.policy.bind(tdg, db, budget, config, self.rng)
        self.n_sims = 0  # designs this run submitted (backend stats aggregate
        # across sharers; this stays per-exploration under Campaign)
        self.n_nonfinite = 0  # candidate rows rejected for NaN/Inf fitness
        # crash-restart support (serve layer): when enabled, each committed
        # loop top snapshots (rng state, policy checkpoint, iteration) so a
        # dead coroutine can be rebuilt from its last committed accept
        self.track_restart = False
        self._restart_ck: Optional[tuple] = None
        # session-yield point (serve.Session): called whenever an accepted
        # move improves the best-so-far design, with a small event dict —
        # always from committed accept-path state, so every event is a
        # committed improvement
        self.on_improve: Optional[Callable[[dict], None]] = None

    # ---- neighbour generation --------------------------------------------
    def _make_neighbors(
        self, design: Design, focus: Focus, moves: List[str], n: int
    ) -> List[Candidate]:
        """Up to ``n`` *distinct* neighbours: one per move of the policy's
        ordered list (candidate generation in SA, §3.4).

        Clone-free: each move is trialled in place on ``design`` (checkpoint
        → apply, recording its encoding delta → rollback), and the neighbour
        is shipped to the backend as a lightweight :class:`Candidate` — the
        paper's Fig.-8b design-duplication hot-spot never runs. Only the
        accepted candidate is ever materialized (``Candidate.accept``)."""
        direction = +1 if focus.metric == "latency" else -1
        out: List[Candidate] = []
        ck = design.checkpoint()
        for move in moves:
            if len(out) >= n:
                break
            task = focus.task
            delta = MoveDelta()
            ok = apply_move(
                design, self.tdg, move, focus.block, task, direction,
                focus.bneck, focus.metric, self.rng, delta,
            )
            design.restore(ck)
            if not ok and move in ("fork", "fork_swap") and task:
                # a targeted fork is inapplicable when the focus task is the
                # block's anchor (it must stay — apply_fork refuses rather
                # than silently migrating a different task). The untargeted
                # fork — split half the hosted load — is the legitimate
                # relief move for that same congestion, so offer it instead.
                task = None
                delta = MoveDelta()
                ok = apply_move(
                    design, self.tdg, move, focus.block, None, direction,
                    focus.bneck, focus.metric, self.rng, delta,
                )
                design.restore(ck)
            if ok:
                spec = MoveSpec(
                    move, focus.block, task, direction, focus.bneck,
                    focus.metric,
                )
                out.append(
                    Candidate(
                        base=design, spec=spec, delta=delta,
                        budget=self.budget, alpha=self.cfg.alpha_met,
                    )
                )
        return out

    # ---- main loop ---------------------------------------------------------
    def run_steps(
        self, initial: Optional[Design] = None
    ) -> Generator[List[Candidate], List[SimHandle], ExplorationResult]:
        """Coroutine form of the search: yields each iteration's candidate
        batch (lightweight :class:`Candidate` records sharing the current
        design — no clones) and is resumed (``gen.send``) with the matching
        :class:`SimHandle` list. The winner is picked from the handles'
        fitness column (device-computed on the torch backend); an accepted
        winner yields only a :class:`SimTelemetry` view (device bottleneck
        columns + host-exact scalars) for the policy's next selection — the
        full ``SimResult`` decode is paid once, at exploration end, for the
        returned best design.

        This is the HOST accept loop: one yield (one dispatch, one round
        trip) per SA iteration.

        ``run()`` drives it against ``self.backend``; `Campaign` drives many
        explorers' generators in lockstep so one dispatch prices the pending
        neighbours of *all* live explorations. The ``StopIteration`` value
        is the :class:`ExplorationResult`."""
        t0 = time.perf_counter()
        cur = initial or Design.base(self.tdg)
        pol = self.policy
        self._cur = cur  # committed design (mutated in place on accept only)
        if self.track_restart:
            self._restart_ck = (self.rng.getstate(), pol.checkpoint(), 0)
        adopt = getattr(self.backend, "adopt_encoding", None)
        self.n_sims += 1
        (h0,) = yield [Candidate.of_design(cur, self.budget, self.cfg.alpha_met)]
        cur_view: SimTelemetry = h0.telemetry()
        cur_dist = cur_view.dist(self.budget)
        if adopt is not None:
            adopt(h0)
        # best keeps (handle, stable-name design snapshot): cur mutates in
        # place hereafter. The snapshot CLONE is deferred (best_stale) until
        # right after the next dispatch is submitted, so its dict-copy cost
        # hides behind the device scoring that batch — cur cannot mutate
        # again before then. The handle is decoded into the best SimResult
        # only at exploration end (the one decode the search pays).
        best_design, best_handle, best_dist = cur.clone(rename=False), h0, cur_dist
        best_stale = False
        history: List[dict] = []
        max_it = self.cfg.max_iterations

        def select_from(it: int) -> Optional[_Sel]:
            """The head of one serial iteration, from the CURRENT search
            state: policy taboo decay → focus selection → move proposal →
            neighbour generation; iterations yielding no neighbours are
            taboo'd and skipped. Returns None once the iteration budget is
            spent or the search converged (convergence only moves on
            accept)."""
            while it < max_it and not cur_dist.converged():
                pol.tick()
                focus = pol.select_focus(cur, cur_dist, cur_view)
                moves = pol.propose_moves(cur, focus)
                neighbors = self._make_neighbors(
                    cur, focus, moves, self.cfg.neighbors_per_iter
                )
                if neighbors:
                    return _Sel(it, focus, neighbors)
                pol.mark_failed(focus.task, focus.block)
                it += 1
            return None

        def resolve(sel: _Sel, handles: List[SimHandle], u: float) -> bool:
            """Rank batch ``sel`` from its fitness column (the one host pull
            that forces the dispatch) and run the policy's accept test with
            the pre-drawn uniform ``u`` — directly on that column: the
            backend's fitness IS Eq.-7 (device-computed on torch,
            `budgets.distance` on Python), so a rejected iteration never
            reads anything else. Only an accepted winner yields its
            telemetry view for the next selection. Commits the accept-path
            state change; the reject-path taboo add is the caller's."""
            nonlocal cur_view, cur_dist, best_design, best_handle, best_dist, best_stale
            assert len(handles) == len(sel.neighbors)
            # stable argmin preserves the precedence order on ties; the
            # policy's move_penalty rides on the fitness column (0.0 — and
            # bit-neutral — for every policy but dev_cost, so the guard below
            # fires on the backend's fitness, not the penalty), so a system-
            # growing move must buy more PPA than its development cost.
            # Non-finite rows (a poisoned device row, a NaN that leaked
            # through the scal pull) are clamped to +inf so they lose every
            # ranking — argmin over NaN is undefined — and can never be
            # accepted even when the whole batch is poisoned
            fits = []
            for h, c in zip(handles, sel.neighbors):
                f = h.fitness + pol.move_penalty(cur, c)
                if not math.isfinite(f):
                    self.n_nonfinite += 1
                    f = float("inf")
                fits.append(f)
            j = min(range(len(fits)), key=fits.__getitem__)
            cand, move = sel.neighbors[j], sel.neighbors[j].spec.move
            d_before = cur_dist.fitness(self.cfg.alpha_met)
            accept = math.isfinite(fits[j]) and pol.accept(sel.it, d_before, fits[j], u)
            dist_after = None
            if accept:
                # telemetry view, not a decode: device bottleneck columns +
                # the host-exact scalar rollup the next selection needs
                if pol.needs_result:
                    view = SimTelemetry.of_result(
                        handles[j].result(), self.tdg, cand.base
                    )
                else:
                    view = handles[j].telemetry()
                dist_after = view.dist(self.budget)
            pol.record(
                FocusRecord(
                    iteration=sel.it,
                    metric=sel.focus.metric,
                    workload=workload_of(sel.focus.task),
                    comm_comp="comp" if sel.focus.bneck == "pe" else "comm",
                    move=move,
                    distance_before=cur_dist.city_block(),
                    distance_after=dist_after.city_block() if accept else cur_dist.city_block(),
                )
            )
            if accept:
                cand.accept(self.tdg)  # materialize the move onto cur
                if adopt is not None:
                    adopt(handles[j])  # cur's encoding == the winner's row
                cur_view, cur_dist = view, dist_after
                if cur_dist.city_block() < best_dist.city_block():
                    best_handle, best_dist, best_stale = handles[j], cur_dist, True
                    if self.on_improve is not None:
                        # streamed best-design-so-far event: scalars only
                        # (the batch is already forced by the fitness read;
                        # no decode) — the full design decode stays deferred
                        # to exploration end
                        self.on_improve(
                            {
                                "iteration": sel.it,
                                "distance": best_dist.city_block(),
                                "fitness": best_dist.fitness(self.cfg.alpha_met),
                                "move": move,
                                "converged": best_dist.converged(),
                                **handles[j].scalars(),
                            }
                        )
            history.append(
                {
                    "iteration": sel.it,
                    "n_sims": self.n_sims,
                    "distance": best_dist.city_block(),
                    "fitness": best_dist.fitness(self.cfg.alpha_met),
                    "metric": sel.focus.metric,
                    "move": move,
                    "accepted": accept,
                    "wall_s": time.perf_counter() - t0,
                }
            )
            return accept

        sel = select_from(0)
        if sel is not None:
            self.n_sims += len(sel.neighbors)
            handles = yield sel.neighbors
        while sel is not None:
            # loop-top state is always the committed truth: cur only mutates
            # on accept — the one safe point to snapshot for crash-restart
            if self.track_restart:
                self._restart_ck = (self.rng.getstate(), pol.checkpoint(), sel.it)
            # the SA accept draw: consumed BEFORE the next iteration's
            # selection draws, so the rng stream is a pure function of the
            # accepted-move sequence
            u = self.rng.random()
            accepted = resolve(sel, handles, u)  # first host pull forces batch i
            if not accepted:
                pol.mark_failed(sel.focus.task, sel.focus.block)
            sel = select_from(sel.it + 1)
            if sel is None:
                break
            self.n_sims += len(sel.neighbors)
            handles = yield sel.neighbors
            if best_stale:  # deferred snapshot: hides behind the dispatch
                best_design, best_stale = cur.clone(rename=False), False

        if best_stale:
            best_design = cur.clone(rename=False)
        # the exploration's ONE full decode: the returned best result, read
        # against the stable best-design snapshot (the winner's own base has
        # long since mutated past the priced state)
        best_res = best_handle.result_for(best_design)
        return ExplorationResult(
            best_design=best_design,
            best_result=best_res,
            best_distance=best_dist,
            converged=best_dist.converged(),
            iterations=len(history),
            n_sims=self.n_sims,
            wall_s=time.perf_counter() - t0,
            history=history,
            ledger=pol.ledger,
            backend_name=self.backend.name,
            policy_name=pol.name,
        )

    def restart_state(self) -> Optional[dict]:
        """Crash-restart snapshot (serve layer; ``track_restart`` must have
        been on). Returns the last committed accept's ``design`` clone, the
        ``rng``/``policy`` state to restore onto a fresh Explorer, and the
        ``iteration`` the search had reached — or None if the coroutine died
        before the tracking was primed."""
        ck = self._restart_ck
        cur = getattr(self, "_cur", None)
        if ck is None or cur is None:
            return None
        rng_state, pol_ck, it = ck
        return {
            "design": cur.clone(rename=False),
            "rng": rng_state,
            "policy": pol_ck,
            "iteration": it,
        }

    def run(self, initial: Optional[Design] = None) -> ExplorationResult:
        """Drive :meth:`run_steps` against ``self.backend`` — exactly one
        ``backend.evaluate_candidates`` call per search iteration (plus one
        for the initial design). Drains any in-flight dispatch on exit."""
        gen = self.run_steps(initial)
        sim_wall = 0.0
        try:
            pending = next(gen)
            while True:
                t0 = time.perf_counter()
                handles = self.backend.evaluate_candidates(pending)
                sim_wall += time.perf_counter() - t0
                pending = gen.send(handles)
        except StopIteration as stop:
            flush = getattr(self.backend, "flush", None)
            if flush is not None:
                flush()
            result: ExplorationResult = stop.value
            result.sim_wall_s = sim_wall
            return result

    # ---- device-resident chain blocks -------------------------------------
    def run_chain_steps(
        self, initial: Optional[Design] = None
    ) -> Generator[object, list, ExplorationResult]:
        """Chain-batched coroutine form of the search: instead of yielding a
        candidate list per SA iteration, yields one :class:`ChainRequest`
        per fused (R, K) device block and is resumed with the matching
        :class:`ChainBlockResult` (wrapped in a one-element list, so the
        send protocol is that of :meth:`run_steps`). Between blocks the
        winning chain's final mapping is reconciled onto the live design and
        the device carry is stored on the policy (``device_sa`` checkpoints
        it, so a crash restart resumes mid-population). The FINAL yield is
        an ordinary one-candidate batch: the winner pays the usual single
        decode, and nothing else in the search is ever decoded."""
        t0 = time.perf_counter()
        cfg = self.cfg
        r = max(1, cfg.chain_r)
        k = max(1, cfg.chain_k)
        menu = cfg.chain_menu or getattr(self.policy, "device_menu", "naive_sa")
        cur = initial or Design.base(self.tdg)
        pol = self.policy
        self._cur = cur
        carry = getattr(pol, "device_carry", None)
        history: List[dict] = []
        it, max_it = 0, cfg.max_iterations
        res: Optional[ChainBlockResult] = None
        while it < max_it:
            kk = min(k, max_it - it)
            req = ChainRequest(
                design=cur, budget=self.budget, r=r, k=kk, seed=cfg.seed,
                it0=it, menu=menu, alpha=cfg.alpha_met,
                temperature0=cfg.temperature0, temp_decay=cfg.temp_decay,
                taboo_ttl=cfg.taboo_ttl, carry=carry, alloc=cfg.chain_alloc,
            )
            (res,) = yield req
            self.n_sims += r * kk
            carry = res.carry
            if hasattr(pol, "device_carry"):
                pol.device_carry = carry
            if self.track_restart:
                self._restart_ck = (self.rng.getstate(), pol.checkpoint(), it + kk)
            w = res.winner
            for s in range(kk):
                history.append(
                    {
                        "iteration": it + s,
                        "n_sims": self.n_sims,
                        # device path: the trace is the winner chain's Eq.-7
                        # fitness (its city-block distance is only known
                        # after the final decode)
                        "fitness": float(res.fit_trace[w, s]),
                        "move": "chain_mixed" if cfg.chain_alloc
                        else "chain_migrate",
                        "accepted": bool(res.accepted[w, s]),
                        "wall_s": time.perf_counter() - t0,
                    }
                )
            it += kk
            if cfg.chain_alloc:
                # allocation state lives in the carry; the design must stay
                # the seed the provenance columns index, so nothing is
                # reconciled until the run ends (below)
                changed = {"task_pe": {}, "task_mem": {}}
            else:
                changed = reconcile_mapping(
                    cur, res, self.tdg, self.db, self._chain_enc()
                )
            if self.on_improve is not None and (
                changed["task_pe"] or changed["task_mem"]
            ):
                self.on_improve(
                    {
                        "iteration": it,
                        "fitness": float(res.fitness[w]),
                        "move": "chain_block",
                        "chains": r,
                        "changed": sum(map(len, changed.values())),
                    }
                )
        if cfg.chain_alloc and res is not None:
            # one shape change per search: replay the winning chain's
            # platform (clones, removals, retunes, re-homes, mapping)
            # through the moves.py allocation bridge
            reconcile_alloc(cur, res, self.tdg, self.db, self._chain_enc())
        # the ONE decode of the search: the reconciled winner
        self.n_sims += 1
        (h,) = yield [Candidate.of_design(cur, self.budget, cfg.alpha_met)]
        best_dist = h.telemetry().dist(self.budget)
        best_design = cur.clone(rename=False)
        return ExplorationResult(
            best_design=best_design,
            best_result=h.result_for(best_design),
            best_distance=best_dist,
            converged=best_dist.converged(),
            iterations=it,
            n_sims=self.n_sims,
            wall_s=time.perf_counter() - t0,
            history=history,
            ledger=pol.ledger,
            backend_name=self.backend.name,
            policy_name=pol.name,
            chained=True,
            chain_r=r,
        )

    def _chain_enc(self):
        """The backend's cached workload encoding when it has one (so slot
        dicts match its rows), else a lazily-built local one."""
        enc = getattr(self.backend, "_enc", None)
        if enc is None:
            enc = getattr(self, "_own_enc", None)
            if enc is None:
                from .phase_sim_torch import EncodedWorkload

                enc = self._own_enc = EncodedWorkload.of(self.tdg)
        return enc

    def run_chains(self, initial: Optional[Design] = None) -> ExplorationResult:
        """Drive :meth:`run_chain_steps` against ``self.backend`` — one
        ``backend.run_chains`` dispatch per (R, K) block (the backend must
        support device chains, i.e. expose ``run_chains``), plus the final
        winner decode through the ordinary candidate path."""
        if not hasattr(self.backend, "run_chains"):
            raise ValueError(
                f"backend {self.backend.name!r} does not support device "
                "chain blocks (no run_chains)"
            )
        gen = self.run_chain_steps(initial)
        sim_wall = 0.0
        try:
            pending = next(gen)
            while True:
                t0 = time.perf_counter()
                if isinstance(pending, ChainRequest):
                    answer = [self.backend.run_chains(pending)]
                else:
                    answer = self.backend.evaluate_candidates(pending)
                sim_wall += time.perf_counter() - t0
                pending = gen.send(answer)
        except StopIteration as stop:
            flush = getattr(self.backend, "flush", None)
            if flush is not None:
                flush()
            result: ExplorationResult = stop.value
            result.sim_wall_s = sim_wall
            return result
