"""Campaign: many explorations, one cross-batched simulation stream.

FARSI's experiments are never a single search — Fig. 9/10 average seeds,
Fig. 9b sweeps the awareness ladder, §6 sweeps budgets and workloads. A
``Campaign`` declares that whole grid up front, then runs it as a thin
client of the serve layer's continuous-batching engine
(`repro_torch.serve.ContinuousBatchScheduler`): every run becomes a
`Session` admitted before the first tick, and each tick packs the pending
candidate batches of *all* live explorers on a workload into **one**
``backend.evaluate_candidates`` dispatch. Because every session joins up
front and per-row results are independent of batch composition, this is
exactly a lockstep sweep — same converged runs, same iteration counts —
while mid-flight-joining consumers (``repro_torch.serve.DseService``) share
the identical engine. With `TorchBatchedBackend` that turns N concurrent
searches into single launches of the CUDA phase-sim kernel over
N×neighbours delta-encoded candidates (``device="cpu"`` runs its plain
PyTorch version), while `PythonBackend` campaigns still benefit from the
shared accounting. One backend is shared per distinct task graph (the
encoding is workload-specific); per-run ``n_sims`` stays with each
explorer. Passing a ``store=`` (`repro_torch.serve.DesignStore`) memoizes
evaluations content-addressed on ``hash(encoding, workload, budget)`` and
surfaces ``cache_*`` counters in the aggregate.

Runs whose config opts into device chain blocks (``chain_r > 0``) ride the
same engine: their sessions yield :class:`~repro_torch.core.device_explore.ChainRequest`
blocks that the scheduler prices as one fused device dispatch each, instead
of joining the shared candidate pack. ``run()`` flushes every backend before
reporting so no abandoned dispatch outlives the campaign.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

from .backend import BackendStats, SimulatorBackend
from .budgets import Budget
from .codesign import aggregate_ledgers
from .database import HardwareDatabase
from .design import Design
from .explorer import ExplorationResult, Explorer, ExplorerConfig
from .tdg import TaskGraph


@dataclasses.dataclass
class RunSpec:
    """One exploration of a campaign grid."""

    name: str
    tdg: TaskGraph
    budget: Budget
    config: ExplorerConfig = dataclasses.field(default_factory=ExplorerConfig)
    initial: Optional[Design] = None


_COMPLEXITY_KEYS = ("components", "noc_components", "variation")
# a run whose config keeps this backend follows the campaign's
_DEFAULT_BACKEND = ExplorerConfig().backend


def _complexity_by_policy(
    results: Iterable[ExplorationResult],
) -> Dict[str, List[Dict[str, float]]]:
    """Best-design `Design.complexity_metrics()` grouped by policy name —
    shared by `CampaignResult.policy_complexity` and the grid aggregate."""
    acc: Dict[str, List[Dict[str, float]]] = {}
    for r in results:
        acc.setdefault(r.policy_name, []).append(
            r.best_design.complexity_metrics()
        )
    return acc


@dataclasses.dataclass
class CampaignResult:
    runs: Dict[str, ExplorationResult]  # per-run, keyed by RunSpec.name
    aggregate: Dict[str, float]  # convergence statistics over the grid
    backend_stats: Dict[str, BackendStats]  # per shared backend (workload name)
    wall_s: float

    def converged_runs(self) -> List[str]:
        return [n for n, r in self.runs.items() if r.converged]

    def iterations_to_budget(self, cap: Optional[int] = None) -> Dict[str, float]:
        """Per-run iterations-to-budget (censored at ``cap`` / the run's own
        iteration count when not converged) — the policy-comparison metric."""
        return {n: r.iterations_to_budget(cap) for n, r in self.runs.items()}

    def policy_iterations(self, cap: Optional[int] = None) -> Dict[str, float]:
        """Mean iterations-to-budget per policy, read from each run's
        ``policy_name`` — the summary a policy × scenario sweep reports."""
        acc: Dict[str, List[float]] = {}
        for r in self.runs.values():
            acc.setdefault(r.policy_name, []).append(r.iterations_to_budget(cap))
        return {p: statistics.mean(v) for p, v in acc.items()}

    def policy_complexity(self) -> Dict[str, Dict[str, float]]:
        """Mean development-cost metrics of each policy's best designs
        (``Design.complexity_metrics``: component count, NoC-subsystem
        count, heterogeneity variation) — the §5.3 comparison surface for
        ``dev_cost`` vs ``farsi``."""
        return {
            p: {
                k: statistics.mean(m[k] for m in ms)
                for k in _COMPLEXITY_KEYS
            }
            for p, ms in _complexity_by_policy(self.runs.values()).items()
        }


class Campaign:
    """Declarative multi-exploration runner sharing one backend per workload.

    >>> camp = Campaign(db)   # the card; Campaign(db, device="cpu") off it
    >>> camp.add("audio.s1", g_audio, budget, ExplorerConfig(seed=1))
    >>> camp.add("audio.s2", g_audio, budget, ExplorerConfig(seed=2))
    >>> result = camp.run()   # both searches share one dispatch stream
    """

    def __init__(
        self,
        db: HardwareDatabase,
        backend: Union[str, Callable[[TaskGraph, HardwareDatabase], SimulatorBackend]] = "torch",
        store=None,  # Optional[serve.DesignStore]: content-addressed eval cache
        device=None,  # where the batched backend prices: None = the card
    ) -> None:
        # the serve layer builds on this package, so it is imported here,
        # not at module import time
        from ..serve.scheduler import ContinuousBatchScheduler

        self.db = db
        self._backend_spec = backend
        self.specs: List[RunSpec] = []
        self.store = store
        # the campaign engine; it resolves the device now, so a campaign
        # asked for the card raises on a machine without one
        self._scheduler = ContinuousBatchScheduler(
            db, backend, store=store, device=device
        )

    # ---- declaration ---------------------------------------------------
    def add(
        self,
        name: str,
        tdg: TaskGraph,
        budget: Budget,
        config: Optional[ExplorerConfig] = None,
        initial: Optional[Design] = None,
    ) -> "Campaign":
        if any(s.name == name for s in self.specs):
            raise ValueError(f"duplicate run name {name!r}")
        config = config or ExplorerConfig()
        # runs share the campaign backend; a config asking for a *different*
        # one would be silently overridden — refuse instead (the config's
        # default backend is treated as unset and follows the campaign)
        campaign_be = self._backend_spec if isinstance(self._backend_spec, str) else None
        if config.backend != _DEFAULT_BACKEND and config.backend != campaign_be:
            raise ValueError(
                f"run {name!r} requests backend {config.backend!r} but the "
                f"campaign shares backend {self._backend_spec!r} across runs"
            )
        self.specs.append(RunSpec(name, tdg, budget, config, initial))
        return self

    @classmethod
    def sweep(
        cls,
        db: HardwareDatabase,
        workloads: Dict[str, TaskGraph],
        budgets: Union[Budget, Dict[str, Budget]],
        seeds: Iterable[int] = (0,),
        awareness: Sequence[str] = ("farsi",),
        backend: Union[str, Callable] = "torch",
        device=None,
        **config_kw,
    ) -> "Campaign":
        """Multi-seed × multi-workload × awareness-ladder grid. Reusing one
        graph object per workload keys every run of it onto one shared
        backend."""
        camp = cls(db, backend=backend, device=device)
        if isinstance(backend, str):
            config_kw.setdefault("backend", backend)
        for wl_name, tdg in workloads.items():
            bud = budgets[wl_name] if isinstance(budgets, dict) else budgets
            for level in awareness:
                for seed in seeds:
                    camp.add(
                        f"{wl_name}.{level}.s{seed}",
                        tdg,
                        bud,
                        ExplorerConfig(awareness=level, seed=seed, **config_kw),
                    )
        return camp

    @classmethod
    def policy_sweep(
        cls,
        db: HardwareDatabase,
        scenarios: Sequence,  # Iterable[workloads.Scenario]
        policies: Sequence[str] = ("naive_sa", "farsi"),
        seeds: Iterable[int] = (0,),
        backend: Union[str, Callable] = "torch",
        device=None,
        **config_kw,
    ) -> "Campaign":
        """Policy × scenario grid over a generated workload family
        (`workloads.synthetic_family`): every scenario carries its own graph
        and calibrated budget, every policy runs under every seed, and all
        runs of one scenario share one backend. Summarize with
        ``CampaignResult.policy_iterations()``."""
        camp = cls(db, backend=backend, device=device)
        if isinstance(backend, str):
            config_kw.setdefault("backend", backend)
        for scen in scenarios:
            for pol in policies:
                for seed in seeds:
                    camp.add(
                        f"{scen.name}.{pol}.s{seed}",
                        scen.tdg,
                        scen.budget,
                        ExplorerConfig(policy=pol, seed=seed, **config_kw),
                    )
        return camp

    # ---- execution -----------------------------------------------------
    def backend_for(self, tdg: TaskGraph) -> SimulatorBackend:
        return self._scheduler.backend_for(tdg)

    def run(self) -> CampaignResult:
        """Drive the whole grid through the continuous-batching scheduler.

        Every spec is admitted up front, so the serve loop degenerates to
        exactly a lockstep sweep: each tick packs all live runs' pending
        batches per shared backend into one dispatch, and per-row results
        are independent of batch composition.
        """
        t0 = time.perf_counter()
        if not self.specs:
            raise ValueError("empty campaign: nothing to run")
        from ..serve.session import Session, SessionRequest

        sched = self._scheduler
        sessions: List = []
        for spec in self.specs:
            ex = Explorer(
                spec.tdg, self.db, spec.budget, spec.config,
                backend=sched.backend_for(spec.tdg),
            )
            req = SessionRequest(
                spec.name, spec.tdg, spec.budget, spec.config, spec.initial
            )
            session = Session(req, ex)
            sessions.append(session)
            sched.admit(session)
        sched.run_until_idle()
        # drain: un-consumed dispatches must not outlive the run
        sched.flush()

        runs = {s.name: s.result for s in sessions}  # spec order preserved
        labels = self._backend_labels()
        backend_stats = {
            labels[tdg_id]: b.stats() for tdg_id, b in sched.backends().items()
        }
        aggregate = self._aggregate(runs)
        # content-addressed cache accounting (zeros when no store attached):
        # hits+aliases avoided device rows; bypasses took the scalar path
        hits = sum(s.n_cache_hits for s in backend_stats.values())
        misses = sum(s.n_cache_misses for s in backend_stats.values())
        aggregate["cache_hits_total"] = hits
        aggregate["cache_misses_total"] = misses
        aggregate["cache_bypass_total"] = sum(
            s.n_cache_bypass for s in backend_stats.values()
        )
        aggregate["cache_hit_rate"] = hits / (hits + misses) if hits + misses else 0.0
        return CampaignResult(
            runs=runs,
            aggregate=aggregate,
            backend_stats=backend_stats,
            wall_s=time.perf_counter() - t0,
        )

    def _backend_labels(self) -> Dict[int, str]:
        """One stable label per backend: the graph name, suffixed ``#n`` when
        distinct graph objects share a name (they get distinct backends)."""
        labels: Dict[int, str] = {}
        counts: Dict[str, int] = {}
        for spec in self.specs:
            key = id(spec.tdg)
            if key in labels:
                continue
            n = counts.get(spec.tdg.name, 0)
            labels[key] = spec.tdg.name if n == 0 else f"{spec.tdg.name}#{n}"
            counts[spec.tdg.name] = n + 1
        return labels

    @staticmethod
    def _aggregate(runs: Dict[str, ExplorationResult]) -> Dict[str, float]:
        iters = [r.iterations for r in runs.values()]
        dists = [r.best_distance.city_block() for r in runs.values()]
        conv_iters = [r.iterations for r in runs.values() if r.converged]
        # Fig.-10 co-design aggregates: per-run ledgers used to be dropped on
        # aggregation — surface the grid-level switch-rate / convergence-
        # contribution means alongside the convergence statistics
        codesign = aggregate_ledgers([r.ledger for r in runs.values()])
        # §5.3 development-cost aggregates: grid-level means of the best
        # designs' complexity metrics, plus the headline dev_cost-vs-farsi
        # reductions — reported as the bounded fraction
        # (farsi − dev_cost) / farsi (1.0 = eliminated entirely; the
        # paper's ratio form explodes when dev_cost drives a metric to
        # zero) — when both policies ran in this grid
        by_pol = _complexity_by_policy(runs.values())
        comp = [m for ms in by_pol.values() for m in ms]
        complexity = {
            f"complexity_{k}_mean": statistics.mean(m[k] for m in comp)
            for k in _COMPLEXITY_KEYS
        }
        if "farsi" in by_pol and "dev_cost" in by_pol:
            for k in _COMPLEXITY_KEYS:
                f = statistics.mean(m[k] for m in by_pol["farsi"])
                d = statistics.mean(m[k] for m in by_pol["dev_cost"])
                complexity[f"dev_cost_{k}_reduction"] = (
                    (f - d) / f if f > 0 else 0.0
                )
        return {
            **codesign,
            **complexity,
            "n_runs": len(runs),
            "n_converged": sum(r.converged for r in runs.values()),
            "convergence_rate": statistics.mean(
                [1.0 if r.converged else 0.0 for r in runs.values()]
            ),
            "iterations_mean": statistics.mean(iters),
            "iterations_median": statistics.median(iters),
            "converged_iterations_mean": statistics.mean(conv_iters) if conv_iters else float("nan"),
            "best_distance_mean": statistics.mean(dists),
            "best_distance_max": max(dists),
            "n_sims_total": sum(r.n_sims for r in runs.values()),
            "sim_wall_s_total": sum(r.sim_wall_s for r in runs.values()),
        }
