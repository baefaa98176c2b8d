"""`DseService`: the serve-layer front door.

One service hosts many concurrent, multi-tenant exploration sessions over
shared per-workload backends and one content-addressed
:class:`~repro_torch.serve.store.DesignStore`. Sessions are submitted at any time
(`submit` between ticks is the mid-flight join), priced together by the
:class:`~repro_torch.serve.scheduler.ContinuousBatchScheduler`, stream
best-design-so-far events while running, and deliver a final decoded
winner in their ``ExplorationResult``.

Typical use (on the card; pass ``device="cpu"`` to price on the CPU)::

    svc = DseService(db)
    h1 = svc.submit("alice.audio", g_audio, budget, ExplorerConfig(seed=1))
    h2 = svc.submit("bob.audio", g_audio, budget, ExplorerConfig(seed=2))
    svc.run()                      # tick until every session completes
    print(h1.result.best_distance.city_block(), svc.stats().cache_hit_rate)

`DseService.step()` exposes single-tick control for callers interleaving
their own admission logic (arrival traces, latency injection, backpressure).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..core.backend import BackendStats
from ..core.budgets import Budget
from ..core.design import Design
from ..core.explorer import Explorer, ExplorerConfig
from ..core.database import HardwareDatabase
from ..core.tdg import TaskGraph
from .faults import FaultInjector, RetryPolicy, SessionFailed
from .scheduler import BackendSpec, ContinuousBatchScheduler
from .session import BestEvent, Session, SessionRequest
from .store import DesignStore


@dataclasses.dataclass
class ServiceStats:
    """Fleet-level serve accounting, snapshotted by :meth:`DseService.stats`.

    The fault-tolerance block (``n_failed`` … ``n_straggler_ticks``)
    reconciles against a :class:`~repro_torch.serve.faults.FaultInjector`'s
    schedule in the chaos tests and is all-zero on a healthy service."""

    n_sessions: int
    n_done: int
    n_ticks: int
    wall_s: float  # total time inside tick-driving calls (run/step)
    n_evals: int  # candidate evaluations submitted across all backends
    n_fallback: int  # scalar-path evaluations (0 in the array-native regime)
    cache_hits: int
    cache_misses: int
    cache_bypasses: int
    cache_evictions: int
    session_latency_s: List[float]  # completed sessions, admission → done
    # ---- fault tolerance -------------------------------------------------
    n_failed: int = 0  # sessions quarantined to FAILED
    n_degraded: int = 0  # sessions pinned to the PythonBackend fallback
    n_degraded_evals: int = 0  # evaluations priced on fallback backends
    n_restarts: int = 0  # coroutine crash-restarts performed
    n_retries: int = 0  # backed-off per-session dispatch re-attempts
    n_dispatch_faults: int = 0  # dispatch attempts that raised
    n_bisects: int = 0  # shared dispatches split after a fault
    n_deadline_exceeded: int = 0  # sessions failed by their deadline_s SLO
    n_nonfinite_rejected: int = 0  # NaN/Inf candidate rows rejected, never accepted
    n_straggler_ticks: int = 0  # ticks the StepTimeMonitor EMA flagged

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0

    def latency_percentile(self, p: float) -> float:
        """p in [0, 100] over completed-session latencies (0.0 when none)."""
        lats = sorted(self.session_latency_s)
        if not lats:
            return 0.0
        k = min(len(lats) - 1, max(0, round(p / 100.0 * (len(lats) - 1))))
        return lats[k]

    @property
    def evals_per_s(self) -> float:
        return self.n_evals / self.wall_s if self.wall_s > 0 else 0.0


class SessionHandle:
    """User-facing view of one submitted session: poll ``done`` (or
    ``failed``), read the streamed ``events``, and collect the final
    ``result`` after completion. A FAILED session's ``result`` raises
    :class:`~repro_torch.serve.faults.SessionFailed` with the quarantined error
    (also exposed directly as ``error``)."""

    def __init__(self, session: Session) -> None:
        self._session = session

    @property
    def name(self) -> str:
        return self._session.name

    @property
    def done(self) -> bool:
        return self._session.done

    @property
    def failed(self) -> bool:
        return self._session.failed

    @property
    def state(self) -> str:
        return self._session.state

    @property
    def error(self) -> Optional[BaseException]:
        """The error that failed the session (None unless FAILED)."""
        return self._session.error

    @property
    def degraded(self) -> bool:
        """True once the session was pinned to the PythonBackend fallback."""
        return self._session.degraded

    @property
    def events(self) -> List[BestEvent]:
        return self._session.events

    @property
    def latency_s(self) -> float:
        return self._session.latency_s

    @property
    def result(self):
        if self._session.failed:
            raise SessionFailed(
                f"session {self.name!r} failed: {self._session.error!r}"
            ) from self._session.error
        if self._session.result is None:
            raise RuntimeError(
                f"session {self.name!r} has not completed (state="
                f"{self._session.state}); drive DseService.run()/step() first"
            )
        return self._session.result


class DseService:
    """Multi-session DSE serving over one continuous-batching scheduler.

    The evaluation cache defaults ON (a fresh :class:`DesignStore` per
    service); pass ``store=`` to share one across services or
    ``cache=False`` for the uncached baseline. ``backend`` accepts the
    ``make_backend`` registry names or a factory, exactly like ``Campaign``;
    ``device`` is where a registry-named batched backend prices (``None``:
    the card, raising where there is none).
    """

    def __init__(
        self,
        db: HardwareDatabase,
        backend: BackendSpec = "torch",
        store: Optional[DesignStore] = None,
        cache: bool = True,
        faults: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        device=None,
    ) -> None:
        self.db = db
        self.store = store if store is not None else (DesignStore() if cache else None)
        self.scheduler = ContinuousBatchScheduler(
            db, backend, store=self.store, faults=faults, retry=retry,
            device=device,
        )
        self._sessions: Dict[str, Session] = {}  # admission order preserved
        self._wall_s = 0.0

    # ---- admission -------------------------------------------------------
    def submit(
        self,
        name: str,
        tdg: TaskGraph,
        budget: Budget,
        config: Optional[ExplorerConfig] = None,
        initial: Optional[Design] = None,
        on_event=None,  # Optional[Callable[[BestEvent], None]]
        deadline_s: Optional[float] = None,
        max_restarts: int = 0,
    ) -> SessionHandle:
        """Admit one exploration session; it joins the next scheduler tick
        (mid-flight joins are the normal case, not an exception).
        ``on_event`` streams the session's BestEvents as they commit;
        ``deadline_s`` is a per-session completion SLO enforced every tick;
        ``max_restarts`` budgets crash-restarts from the last committed
        accept."""
        return self.submit_request(
            SessionRequest(
                name, tdg, budget, config or ExplorerConfig(), initial,
                deadline_s=deadline_s, max_restarts=max_restarts,
            ),
            on_event=on_event,
        )

    def submit_request(self, request: SessionRequest, on_event=None) -> SessionHandle:
        if request.name in self._sessions:
            raise ValueError(f"duplicate session name {request.name!r}")
        explorer = Explorer(
            request.tdg, self.db, request.budget, request.config,
            backend=self.scheduler.backend_for(request.tdg),
        )
        session = Session(request, explorer)
        session.on_event = on_event
        self._sessions[request.name] = session
        self.scheduler.admit(session)
        return SessionHandle(session)

    # ---- drive -----------------------------------------------------------
    def step(self) -> List[SessionHandle]:
        """One scheduler tick; returns handles of sessions that completed."""
        t0 = time.perf_counter()
        done = self.scheduler.tick()
        self._wall_s += time.perf_counter() - t0
        return [SessionHandle(s) for s in done]

    def run(self, max_ticks: Optional[int] = None) -> ServiceStats:
        """Tick until every admitted session completes (or ``max_ticks``),
        drain the backends, and return the service stats snapshot."""
        t0 = time.perf_counter()
        self.scheduler.run_until_idle(max_ticks)
        self.scheduler.flush()
        self._wall_s += time.perf_counter() - t0
        return self.stats()

    # ---- observability ---------------------------------------------------
    @property
    def n_live(self) -> int:
        return self.scheduler.n_live

    def backend_stats(self) -> Dict[str, BackendStats]:
        """Per shared backend, labeled by workload (graph) name — distinct
        graph objects sharing a name get ``#n`` suffixes."""
        labels: Dict[int, str] = {}
        counts: Dict[str, int] = {}
        for s in self._sessions.values():
            key = id(s.request.tdg)
            if key in labels:
                continue
            n = counts.get(s.request.tdg.name, 0)
            labels[key] = s.request.tdg.name if n == 0 else f"{s.request.tdg.name}#{n}"
            counts[s.request.tdg.name] = n + 1
        out = {
            labels.get(k, str(k)): b.stats()
            for k, b in self.scheduler.backends().items()
        }
        for k, b in self.scheduler.fallback_backends().items():
            out[labels.get(k, str(k)) + "~degraded"] = b.stats()
        return out

    def stats(self) -> ServiceStats:
        sched = self.scheduler
        bstats = list(sched.backend_stats().values())
        fstats = [b.stats() for b in sched.fallback_backends().values()]
        sstats = self.store.stats if self.store is not None else None
        return ServiceStats(
            n_sessions=len(self._sessions),
            n_done=sum(1 for s in self._sessions.values() if s.done),
            n_ticks=sched.n_ticks,
            wall_s=self._wall_s,
            n_evals=sum(b.n_sims for b in bstats) + sum(b.n_sims for b in fstats),
            n_fallback=sum(b.n_fallback for b in bstats),
            cache_hits=sstats.hits if sstats else 0,
            cache_misses=sstats.misses if sstats else 0,
            cache_bypasses=sstats.bypasses if sstats else 0,
            cache_evictions=sstats.evictions if sstats else 0,
            session_latency_s=[
                s.latency_s for s in self._sessions.values() if s.done
            ],
            n_failed=sched.n_failed,
            n_degraded=sched.n_degraded,
            n_degraded_evals=sum(b.n_sims for b in fstats),
            n_restarts=sched.n_restarts,
            n_retries=sched.n_retries,
            n_dispatch_faults=sched.n_dispatch_faults,
            n_bisects=sched.n_bisects,
            n_deadline_exceeded=sched.n_deadline_exceeded,
            n_nonfinite_rejected=sum(
                s.n_nonfinite_rejected for s in self._sessions.values()
            ),
            n_straggler_ticks=sched.n_straggler_ticks,
        )

    def results(self) -> Dict[str, object]:
        """Completed sessions' ExplorationResults, in admission order."""
        return {
            name: s.result for name, s in self._sessions.items() if s.done
        }

    def failures(self) -> Dict[str, BaseException]:
        """FAILED sessions' quarantined errors, in admission order."""
        return {
            name: s.error
            for name, s in self._sessions.items()
            if s.failed and s.error is not None
        }
