"""One multi-tenant exploration session around the Explorer coroutine.

A :class:`Session` owns one Explorer coroutine —
:meth:`~repro_torch.core.explorer.Explorer.run_steps` (host accept loop), or
:meth:`~repro_torch.core.explorer.Explorer.run_chain_steps` when the request's
config opts into chain-batched ticks (``chain_r > 0``) — and the
bookkeeping the scheduler needs to co-batch it with strangers: the pending
batch, lifecycle state, streamed best-design events, and per-session
latency/throughput accounting. The session never talks to a backend — the
scheduler prices its pending batch (packed with every other live
session's, or dispatched as one fused device block for a chain session)
and hands the result back through :meth:`resume`.

Streaming contract: every committed best-so-far improvement fires a
:class:`BestEvent` (wired to ``Explorer.on_improve`` — scalar columns only,
no decode); the final decoded winner arrives once, in the
``ExplorationResult`` captured at ``StopIteration``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from ..core.backend import Candidate, SimHandle
from ..core.budgets import Budget
from ..core.design import Design
from ..core.explorer import ExplorationResult, Explorer, ExplorerConfig
from ..core.tdg import TaskGraph

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


@dataclasses.dataclass
class SessionRequest:
    """One exploration request, shaped like ``campaign.RunSpec`` — the serve
    layer's admission unit.

    ``deadline_s`` is a per-session admission→completion wall-clock SLO,
    enforced at the top of every scheduler tick (a session past it fails
    with ``DeadlineExceeded``). ``max_restarts`` bounds crash recovery: a
    coroutine that dies with restarts left is rebuilt from the explorer's
    last committed accept (rng + policy checkpoint) instead of failing."""

    name: str
    tdg: TaskGraph
    budget: Budget
    config: ExplorerConfig = dataclasses.field(default_factory=ExplorerConfig)
    initial: Optional[Design] = None
    deadline_s: Optional[float] = None
    max_restarts: int = 0


@dataclasses.dataclass(frozen=True)
class BestEvent:
    """One streamed best-design-so-far improvement (scalars only — the full
    decode is paid once, for the final winner)."""

    session: str
    iteration: int
    distance: float
    fitness: float
    move: str
    converged: bool
    latency_s: float
    power_w: float
    area_mm2: float
    wall_s: float  # seconds since the session was admitted


class Session:
    """Lifecycle: ``PENDING`` (declared) → ``RUNNING`` (``start`` primed the
    coroutine; ``pending`` holds the batch awaiting pricing) → ``DONE``
    (``result`` captured). Joining mid-flight is just calling ``start``
    between two scheduler ticks — co-batching never perturbs a session's
    own search (per-row results are independent of batch composition, which
    is what makes a late joiner converge exactly as if it ran alone)."""

    def __init__(self, request: SessionRequest, explorer: Explorer) -> None:
        self.request = request
        self.explorer = explorer
        self.state = PENDING
        self.pending: List[Candidate] = []
        self.result: Optional[ExplorationResult] = None
        self.error: Optional[BaseException] = None  # set iff FAILED
        self.events: List[BestEvent] = []
        self.on_event: Optional[Callable[[BestEvent], None]] = None
        self.sim_wall_s = 0.0  # attributed share of shared-dispatch wall
        self.n_ticks = 0
        self.admitted_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.degraded = False  # pinned to the PythonBackend fallback
        self.n_consec_dispatch_failures = 0  # drives the degradation ladder
        self.n_restarts = 0
        self._nonfinite_base = 0  # rejections from pre-restart explorers
        explorer.on_improve = self._improved
        if request.max_restarts > 0:
            explorer.track_restart = True

    @property
    def name(self) -> str:
        return self.request.name

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def failed(self) -> bool:
        return self.state == FAILED

    @property
    def restarts_left(self) -> int:
        return max(0, self.request.max_restarts - self.n_restarts)

    @property
    def n_nonfinite_rejected(self) -> int:
        """Non-finite candidate rows this session's search rejected (summed
        across crash-restarted explorer instances)."""
        return self._nonfinite_base + getattr(self.explorer, "n_nonfinite", 0)

    def past_deadline(self) -> bool:
        d = self.request.deadline_s
        return (
            d is not None
            and self.admitted_at is not None
            and time.perf_counter() - self.admitted_at > d
        )

    @property
    def latency_s(self) -> float:
        """Admission → completion wall clock (the serve latency metric);
        admission → now while still running."""
        if self.admitted_at is None:
            return 0.0
        end = self.done_at if self.done_at is not None else time.perf_counter()
        return end - self.admitted_at

    def _improved(self, ev: dict) -> None:
        # chain-block events carry fitness only (the winner's PPA scalars
        # stay on device until the final decode) — missing columns default
        event = BestEvent(
            session=self.request.name,
            iteration=ev["iteration"],
            distance=ev.get("distance", float("nan")),
            fitness=ev["fitness"],
            move=ev["move"],
            converged=ev.get("converged", False),
            latency_s=ev.get("latency_s", float("nan")),
            power_w=ev.get("power_w", float("nan")),
            area_mm2=ev.get("area_mm2", float("nan")),
            wall_s=time.perf_counter() - (self.admitted_at or time.perf_counter()),
        )
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)

    def _make_gen(self, explorer: Explorer, initial: Optional[Design]):
        """The session's coroutine: the chain-batched generator when the
        request opted into device chain blocks (``chain_r > 0``), the host
        accept loop otherwise."""
        if self.request.config.chain_r > 0:
            return explorer.run_chain_steps(initial)
        return explorer.run_steps(initial)

    # ---- scheduler interface --------------------------------------------
    def start(self) -> None:
        """Prime the coroutine: after this the session is RUNNING and
        ``pending`` holds its first candidate batch (the initial design)."""
        assert self.state == PENDING, f"session {self.name!r} already started"
        self.admitted_at = time.perf_counter()
        self._gen = self._make_gen(self.explorer, self.request.initial)
        try:
            self.pending = next(self._gen)
            self.state = RUNNING
        except StopIteration as stop:  # pragma: no cover — degenerate search
            self._finish(stop.value)

    def resume(self, handles: Sequence[SimHandle]) -> bool:
        """Feed the priced handles for the current ``pending`` batch; returns
        True when the session just completed."""
        assert self.state == RUNNING, self.state
        self.n_ticks += 1
        try:
            self.pending = self._gen.send(list(handles))
            return False
        except StopIteration as stop:
            self._finish(stop.value)
            return True

    def _finish(self, result: ExplorationResult) -> None:
        result.sim_wall_s = self.sim_wall_s
        self.result = result
        self.pending = []
        self.state = DONE
        self.done_at = time.perf_counter()

    # ---- fault handling --------------------------------------------------
    def fail(self, exc: BaseException) -> None:
        """Quarantine the session: record the error, transition to FAILED,
        and close the coroutine so half-finished search state cannot leak.
        Idempotent for already-terminal sessions (the first error wins)."""
        if self.state in (DONE, FAILED):
            return
        self.error = exc
        self.pending = []
        self.state = FAILED
        self.done_at = time.perf_counter()
        gen = getattr(self, "_gen", None)
        if gen is not None:
            try:
                gen.close()
            except Exception:  # a broken coroutine must not take the tick down
                pass

    def crash(self, exc: BaseException) -> Optional[BaseException]:
        """Throw ``exc`` into the session coroutine (the injected-crash
        path). Returns the exception that escaped — usually ``exc`` itself —
        or None if the coroutine absorbed it / ran to completion."""
        assert self.state == RUNNING, self.state
        self.pending = []
        try:
            self.pending = self._gen.throw(exc)
            return None  # absorbed; pending is the next batch
        except StopIteration as stop:  # pragma: no cover — graceful wind-down
            self._finish(stop.value)
            return None
        except BaseException as escaped:
            return escaped

    def resurrect(self, explorer: Explorer, initial: Optional[Design]) -> None:
        """Crash-restart: swap in a fresh explorer (rng/policy already
        restored to the last committed accept by the scheduler) and re-prime
        the coroutine from ``initial`` — the last accepted design. Events,
        latency accounting, and tick counts carry over; only the in-flight
        (uncommitted) step is lost."""
        assert self.state == RUNNING, self.state
        self._nonfinite_base += getattr(self.explorer, "n_nonfinite", 0)
        self.explorer = explorer
        explorer.on_improve = self._improved
        explorer.track_restart = True
        self.n_restarts += 1
        self._gen = self._make_gen(explorer, initial)
        try:
            self.pending = next(self._gen)
        except StopIteration as stop:  # pragma: no cover — budget exhausted
            self._finish(stop.value)
