"""Seeded fault injection + fault-tolerance primitives for the serve layer.

The ROADMAP's "thousands of sessions" goal makes the serve path's failure
behaviour a first-class property: one poisoned candidate, a non-finite
fitness row, or a transient backend hiccup must cost *its* session — never
the tick, never the service. This module provides both sides of that
contract:

  * the **policy surface** the scheduler enforces — :class:`RetryPolicy`
    (capped exponential backoff + the K-consecutive-failures degradation
    ladder) and the typed failure taxonomy (:class:`DeadlineExceeded`,
    :class:`DispatchFailed`, :class:`SessionFailed`);
  * a **seeded, deterministic chaos harness** — :class:`FaultInjector` —
    that injects backend dispatch exceptions, non-finite fitness/scalar
    rows, artificial dispatch latency (stragglers), and session-coroutine
    crashes at configurable rates.

Determinism contract: every injection decision is a draw from one seeded
``random.Random`` consulted at scheduler-deterministic points (per tick, in
live-session admission order, per dispatch attempt, per handle row) and
never gated on wall-clock time — so the same seed produces the same fault
schedule, and (because retried/redispatched rows are bit-identical to the
rows a fault-free run would have produced) the same per-session results.
The injector records every injection in ``schedule``; chaos tests reconcile
that record against the scheduler's ``ServiceStats`` fault counters.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Set

from ..core.backend import SimHandle

# injection kinds (InjectedFault.kind / FaultInjector rate knobs)
DISPATCH = "dispatch"  # evaluate_candidates raises before submission
NAN_ROW = "nan_row"  # a handle's fitness/scalar row turns non-finite
STRAGGLER = "straggler"  # artificial dispatch latency
CRASH = "crash"  # an exception thrown into the session coroutine

# fault kinds that can change the *affected* session's search (dispatch
# faults and stragglers never do: retried/redispatched rows are
# bit-identical, and latency is not an input to the search)
_RESULT_AFFECTING = (NAN_ROW, CRASH)


# ---------------------------------------------------------------------------
# failure taxonomy
# ---------------------------------------------------------------------------
class DeadlineExceeded(RuntimeError):
    """The session's admission→completion wall clock passed its
    ``SessionRequest.deadline_s`` — enforced at the top of every tick."""


class DispatchFailed(RuntimeError):
    """Every dispatch attempt of one session's batch raised, retries and the
    degradation ladder included — the session is quarantined to FAILED."""


class SessionFailed(RuntimeError):
    """Raised by ``SessionHandle.result`` for a FAILED session; the original
    error rides on ``__cause__`` (and on ``handle.error``)."""


class InjectedDispatchError(RuntimeError):
    """A FaultInjector-vetoed dispatch attempt (transient by construction:
    the next attempt draws again)."""


class InjectedSessionCrash(RuntimeError):
    """A FaultInjector-scheduled coroutine crash, thrown into the session's
    generator so the real unwind/quarantine path runs."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-failure handling for one session's dispatch.

    A failed shared dispatch is first bisected to per-session dispatches
    (quarantining the fault to its owner); each per-session dispatch then
    retries up to ``max_attempts`` times with capped exponential backoff.
    ``degrade_after`` consecutive failed primary-backend attempts (counted
    across ticks, reset on any success) drop that one session onto the
    scalar ``PythonBackend`` fallback — the service keeps serving; only a
    session whose *fallback* dispatch also keeps failing reaches FAILED."""

    max_attempts: int = 4  # dispatch attempts per session per tick
    backoff_s: float = 0.001  # sleep before the first retry
    backoff_cap_s: float = 0.05  # exponential backoff ceiling
    degrade_after: int = 3  # consecutive failures → python fallback


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """One scheduled injection (the injector's replay/reconciliation log)."""

    tick: int
    kind: str  # DISPATCH | NAN_ROW | STRAGGLER | CRASH
    target: str  # session name, or "shared:<graph>" for a group dispatch


class FaultInjector:
    """Deterministic chaos source for ``ContinuousBatchScheduler``.

    Rates are per decision point: ``dispatch_fault_rate`` per dispatch
    *attempt* (shared group dispatches and per-session redispatches draw
    independently; degraded python-fallback dispatches are never vetoed —
    the fallback models the known-good path), ``nan_row_rate`` per priced
    handle row, ``straggler_rate`` per group dispatch, ``crash_rate`` per
    live session per tick. ``max_faults`` caps the total number of
    injections (handy for "exactly N transient faults" tests); draws past
    the cap still consume rng state, so the schedule prefix is stable.
    """

    def __init__(
        self,
        seed: int = 0,
        dispatch_fault_rate: float = 0.0,
        nan_row_rate: float = 0.0,
        straggler_rate: float = 0.0,
        crash_rate: float = 0.0,
        straggler_delay_s: float = 0.02,
        max_faults: Optional[int] = None,
    ) -> None:
        self.seed = seed
        self.rates: Dict[str, float] = {
            DISPATCH: dispatch_fault_rate,
            NAN_ROW: nan_row_rate,
            STRAGGLER: straggler_rate,
            CRASH: crash_rate,
        }
        self.straggler_delay_s = straggler_delay_s
        self.max_faults = max_faults
        self.schedule: List[InjectedFault] = []
        self._rng = random.Random(seed)
        self._tick = 0

    # ---- scheduler hooks -------------------------------------------------
    def begin_tick(self, tick: int) -> None:
        self._tick = tick

    def _draw(self, kind: str, target: str) -> bool:
        rate = self.rates[kind]
        if rate <= 0.0:
            return False
        hit = self._rng.random() < rate
        if not hit:
            return False
        if self.max_faults is not None and len(self.schedule) >= self.max_faults:
            return False  # capped: the draw still consumed rng state
        self.schedule.append(InjectedFault(self._tick, kind, target))
        return True

    def draw_dispatch_fault(self, target: str) -> bool:
        """One dispatch attempt's veto draw (True → the scheduler raises
        :class:`InjectedDispatchError` instead of dispatching)."""
        return self._draw(DISPATCH, target)

    def draw_straggler(self, target: str) -> float:
        """Artificial dispatch latency for this group dispatch (seconds;
        0.0 = none). The scheduler sleeps it off inside the tick so the
        ``StepTimeMonitor`` sees a genuine outlier step."""
        return self.straggler_delay_s if self._draw(STRAGGLER, target) else 0.0

    def draw_crash(self, session: str) -> bool:
        """Whether to throw :class:`InjectedSessionCrash` into ``session``'s
        coroutine this tick."""
        return self._draw(CRASH, session)

    def poison_rows(self, session: str, handles: Sequence[SimHandle]) -> List[SimHandle]:
        """Per-row non-finite poisoning: each handle draws independently;
        poisoned rows are wrapped so their fitness and PPA scalars read NaN
        (the explorer's non-finite guard must reject — never accept — them)."""
        if self.rates[NAN_ROW] <= 0.0:
            return list(handles)
        return [
            PoisonedHandle(h) if self._draw(NAN_ROW, session) else h
            for h in handles
        ]

    # ---- reconciliation --------------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Injections performed, per kind — what ``ServiceStats`` fault
        counters reconcile against."""
        out = {k: 0 for k in self.rates}
        for f in self.schedule:
            out[f.kind] += 1
        return out

    def affected_sessions(self) -> Set[str]:
        """Sessions whose *search* an injection may have changed (poisoned
        rows, crashes). Dispatch faults and stragglers are excluded: retried
        and redispatched rows are bit-identical, so those sessions must
        still match a fault-free run exactly (asserted in the chaos tests)."""
        return {
            f.target for f in self.schedule if f.kind in _RESULT_AFFECTING
        }


class PoisonedHandle:
    """A :class:`SimHandle` whose fitness/scalar row reads non-finite.

    Only the *scoring* columns are poisoned — ``telemetry``/``result``
    delegate to the wrapped handle so a defensive read never crashes — and
    the explorer's non-finite guard guarantees a poisoned row loses every
    ranking and is never accepted (counted in
    ``ServiceStats.n_nonfinite_rejected``)."""

    __slots__ = ("_inner",)

    def __init__(self, inner: SimHandle) -> None:
        self._inner = inner

    def __getattr__(self, name):
        # everything but the scoring columns behaves like the real row
        # (adopt_encoding reads ``_cand``/encoding attributes, for one)
        return getattr(self._inner, name)

    @property
    def fitness(self) -> float:
        return float("nan")

    def scalars(self) -> Dict[str, float]:
        return {k: float("nan") for k in ("latency_s", "power_w", "area_mm2")}

    def result(self):
        return self._inner.result()

    def result_for(self, design):
        return self._inner.result_for(design)

    def telemetry(self):
        return self._inner.telemetry()
