"""Continuous batching over shared shape-bucketed device dispatches.

``Campaign`` cross-batches a *fixed* grid of explorations in lockstep; the
scheduler generalizes that to a serve loop: sessions **join and leave
mid-flight**, and each :meth:`tick` packs the pending candidate batches of
every currently-live session — grouped per shared backend (one per distinct
task graph, exactly like Campaign) — into one ``evaluate_candidates``
dispatch per group. The dispatch is non-blocking, per-session handle slices
go back through ``Session.resume``, sessions that finish retire immediately,
and whatever was admitted between ticks rides the next pack.

Per-row results are independent of batch composition (each candidate owns
its device row), so co-batching never changes any session's search — the
determinism that lets a mid-flight joiner converge exactly as if it ran
alone, and lets ``Campaign`` route its lockstep sweeps through this
scheduler without changing a single aggregate.

An attached :class:`~repro_torch.serve.store.DesignStore` turns the pack into a
dedupe point as well: identical candidates across sessions resolve to one
device row (same tick) or to a memoized row (earlier tick — even from a
session that already left).

**Fault isolation.** A fault inside the tick costs its owning session —
never the tick, never the service:

* a shared group dispatch that raises (an injected fault, a mid-batch
  ``UnsupportedDesignError`` that escaped the backend's own fallback) is
  **bisected**: every member session redispatches its own slice alone, so
  the poison is pinned to its owner and the survivors' rows stay
  bit-identical (per-row independence again);
* a per-session dispatch retries with capped exponential backoff
  (:class:`~repro_torch.serve.faults.RetryPolicy`); ``degrade_after`` consecutive
  primary-backend failures pin that one session to a scalar
  ``PythonBackend`` fallback (the service keeps serving); a session whose
  fallback also fails is quarantined to ``FAILED`` with the error recorded
  on it. The scalar fallback prices on the CPU, so it stands in only for
  injected faults and for backends that price on the CPU anyway: a real
  fault of a backend on the card (a kernel that does not build or launch)
  fails its session at once with :class:`~repro_torch.serve.faults.DispatchFailed`,
  the fault on its ``__cause__``;
* chain-batched (``device_sa``) sessions ride the same ladder: their fused
  (R, K) block re-dispatch is deterministic so retries price an identical
  block, and the degraded regime is the host-driven loop (K dispatches of
  the same compiled step at K=1 — bit-identical results by the parity
  contract, at host-loop cost) rather than the scalar fallback, which
  cannot price a device block;
* an exception escaping a session *coroutine* fails (or, with restarts
  budgeted, rebuilds from the explorer's last committed accept via the
  policy checkpoint machinery) that one session;
* per-session ``deadline_s`` SLOs are enforced at the top of every tick;
* an attached :class:`~repro_torch.serve.faults.FaultInjector` exercises all of
  the above deterministically, and a ``runtime.health.StepTimeMonitor``
  EMA-flags straggler ticks.

On the ``torch`` backend every shared dispatch launches the CUDA phase-sim
kernel on the card (``device=None``), and every chain block runs the device
chain block; ``device="cpu"`` prices with the kernel's plain PyTorch version
instead. A dispatch on the card either launches or raises, and a raised card
fault fails its session (counted in ``n_dispatch_faults`` and ``n_failed``):
nothing the caller asked the card for is priced on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

from ..core.backend import (
    BackendStats,
    Candidate,
    PythonBackend,
    SimHandle,
    SimulatorBackend,
    make_backend,
    resolve_device,
)
from ..core.database import HardwareDatabase
from ..core.device_explore import ChainRequest
from ..core.explorer import Explorer
from ..core.tdg import TaskGraph
from ..runtime.health import StepTimeMonitor
from .faults import (
    DeadlineExceeded,
    DispatchFailed,
    FaultInjector,
    InjectedDispatchError,
    InjectedSessionCrash,
    RetryPolicy,
)
from .session import RUNNING, Session
from .store import DesignStore

BackendSpec = Union[str, Callable[[TaskGraph, HardwareDatabase], SimulatorBackend]]


class ContinuousBatchScheduler:
    """Owns the shared backends and the live-session set; drives ticks."""

    def __init__(
        self,
        db: HardwareDatabase,
        backend: BackendSpec = "torch",
        store: Optional[DesignStore] = None,
        faults: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        device=None,
    ) -> None:
        self.db = db
        # where the registry's batched backend prices (None = the card); it is
        # resolved here so a service asked for the card fails at construction
        # on a machine without one, not at its first submit
        self.device = resolve_device(device) if backend == "torch" else device
        self.store = store
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self.monitor = StepTimeMonitor()  # EMA straggler flagging per tick
        self._backend_spec = backend
        self._backends: Dict[int, SimulatorBackend] = {}  # id(tdg) -> backend
        self._fallbacks: Dict[int, PythonBackend] = {}  # degraded-mode backends
        self._live: List[Session] = []  # admission order = packing order
        self.n_ticks = 0
        # fault-tolerance counters (surfaced through ServiceStats)
        self.n_dispatch_faults = 0  # dispatch attempts that raised
        self.n_retries = 0  # backed-off per-session re-attempts
        self.n_bisects = 0  # shared dispatches split after a fault
        self.n_degraded = 0  # sessions pinned to the python fallback
        self.n_failed = 0  # sessions quarantined to FAILED
        self.n_restarts = 0  # crash-restarts performed
        self.n_deadline_exceeded = 0  # sessions failed by their SLO
        self.n_straggler_ticks = 0  # ticks the StepTimeMonitor flagged

    # ---- backends --------------------------------------------------------
    def backend_for(self, tdg: TaskGraph) -> SimulatorBackend:
        """One shared backend per distinct task-graph object (the encoding
        is workload-specific). A store, when configured, is attached to
        every backend that supports it — the store itself is shared, so
        dedupe crosses workload boundaries by digest namespace only."""
        key = id(tdg)
        if key not in self._backends:
            if callable(self._backend_spec):
                backend = self._backend_spec(tdg, self.db)
            else:
                backend = make_backend(self._backend_spec, tdg, self.db,
                                       device=self.device)
            attach = getattr(backend, "attach_store", None)
            if self.store is not None and attach is not None:
                attach(self.store)
            self._backends[key] = backend
        return self._backends[key]

    def fallback_for(self, tdg: TaskGraph) -> PythonBackend:
        """The degraded-mode scalar backend for this graph, built lazily on
        first degradation (a fault-free service never pays for one)."""
        key = id(tdg)
        if key not in self._fallbacks:
            self._fallbacks[key] = PythonBackend(tdg, self.db)
        return self._fallbacks[key]

    @staticmethod
    def _may_degrade(backend: SimulatorBackend, exc: BaseException) -> bool:
        """Whether the CPU fallback may stand in after ``exc``: for an injected
        fault, or where the primary backend prices on the CPU too."""
        if isinstance(exc, InjectedDispatchError):
            return True
        device = getattr(backend, "device", None)
        return device is None or str(device).split(":")[0] != "cuda"

    def backends(self) -> Dict[int, SimulatorBackend]:
        return self._backends

    def fallback_backends(self) -> Dict[int, PythonBackend]:
        return self._fallbacks

    def backend_stats(self) -> Dict[int, BackendStats]:
        return {k: b.stats() for k, b in self._backends.items()}

    # ---- session lifecycle ----------------------------------------------
    @property
    def n_live(self) -> int:
        return len(self._live)

    def admit(self, session: Session) -> None:
        """Start a session and enroll it for the next tick — the mid-flight
        join point. Safe at any moment between ticks."""
        session.start()
        if session.state == RUNNING:
            self._live.append(session)

    # ---- fault paths -----------------------------------------------------
    def _fail(self, session: Session, exc: BaseException) -> None:
        session.fail(exc)
        self.n_failed += 1
        if session in self._live:
            self._live.remove(session)

    def _restart(self, session: Session) -> bool:
        """Rebuild a crashed session's coroutine from its explorer's last
        committed accept: fresh Explorer (budget shrunk to the remaining
        iterations), rng/policy restored through the checkpoint machinery,
        generator re-primed from the last accepted design. Returns False if
        no committed snapshot exists (the scheduler then fails the session)."""
        old = session.explorer
        st = old.restart_state()
        if st is None:
            return False
        remaining = max(1, old.cfg.max_iterations - st["iteration"])
        cfg = dataclasses.replace(old.cfg, max_iterations=remaining)
        ex = Explorer(
            session.request.tdg, self.db, session.request.budget, cfg,
            backend=old.backend,
        )
        ex.rng.setstate(st["rng"])
        ex.policy.restore(st["policy"])
        session.resurrect(ex, st["design"])
        self.n_restarts += 1
        return True

    def _recover(self, session: Session, exc: BaseException, completed: List[Session]) -> None:
        """An exception escaped the session coroutine: crash-restart if the
        request budgeted restarts (and a committed snapshot exists),
        otherwise quarantine to FAILED. Either way the tick — and every
        other session — proceeds untouched."""
        if session.restarts_left > 0 and self._restart(session):
            if session.done:  # pragma: no cover — resurrect hit StopIteration
                completed.append(session)
                self._live.remove(session)
            return
        self._fail(session, exc)

    def _attempt(
        self, backend: SimulatorBackend, cands: List[Candidate], target: str,
        inject: bool,
    ) -> List[SimHandle]:
        """One dispatch attempt, with the injector consulted *before* the
        backend call — a vetoed attempt raises without submitting anything,
        so a retry of the same rows is bit-identical by construction."""
        fi = self.faults
        if fi is not None and inject:
            if fi.draw_dispatch_fault(target):
                raise InjectedDispatchError(f"injected dispatch fault: {target}")
            delay = fi.draw_straggler(target)
            if delay > 0.0:
                time.sleep(delay)  # artificial latency: the monitor's outlier
        return backend.evaluate_candidates(cands)

    def _price_session(self, session: Session) -> Optional[List[SimHandle]]:
        """Price one session's pending batch alone: retry with capped
        exponential backoff on the primary backend, degrade to the scalar
        fallback after ``degrade_after`` consecutive failures (counted
        across ticks, reset on success), FAIL the session only when the
        fallback path fails too — or at once on a real fault of a backend on
        the card, which the CPU fallback must not hide (:meth:`_may_degrade`).
        Returns None iff the session was failed."""
        rp = self.retry
        tdg = session.request.tdg
        if not session.degraded:
            backend = self.backend_for(tdg)
            delay = rp.backoff_s
            last: Optional[BaseException] = None
            for attempt in range(rp.max_attempts):
                if session.n_consec_dispatch_failures >= rp.degrade_after:
                    break  # ladder exhausted: degrade instead of retrying
                if attempt > 0:
                    self.n_retries += 1
                    if delay > 0.0:
                        time.sleep(delay)
                    delay = min(delay * 2.0, rp.backoff_cap_s)
                try:
                    handles = self._attempt(
                        backend, session.pending, session.name, inject=True
                    )
                    session.n_consec_dispatch_failures = 0
                    return handles
                except Exception as exc:
                    self.n_dispatch_faults += 1
                    session.n_consec_dispatch_failures += 1
                    last = exc
                    if not self._may_degrade(backend, exc):
                        failed = DispatchFailed(
                            f"session {session.name!r}: dispatch on "
                            f"{backend.device} failed ({exc!r})"
                        )
                        failed.__cause__ = exc
                        self._fail(session, failed)
                        return None
            if session.n_consec_dispatch_failures < rp.degrade_after:
                self._fail(session, DispatchFailed(
                    f"session {session.name!r}: {rp.max_attempts} dispatch "
                    f"attempts failed (last: {last!r})"
                ))
                return None
            # graceful degradation: pin this one session to the scalar
            # backend; the service keeps serving everyone else on the device
            session.degraded = True
            self.n_degraded += 1
        # degraded path — the known-good backend; the injector never vetoes
        # it (degradation models recovery, not a second failure domain)
        try:
            return self._attempt(
                self.fallback_for(tdg), session.pending,
                session.name + "~degraded", inject=False,
            )
        except Exception as exc:
            self.n_dispatch_faults += 1
            self._fail(session, DispatchFailed(
                f"session {session.name!r}: degraded-mode dispatch failed "
                f"({exc!r})"
            ))
            return None

    def _price_chain_session(self, session: Session):
        """The retry/degrade ladder for a chain-batched session (its pending
        object is a fused (R, K) :class:`ChainRequest`, not a candidate
        list). Same shape as :meth:`_price_session` — retry with capped
        exponential backoff, degrade after ``degrade_after`` consecutive
        failures, FAIL only when the degraded path fails too — with one
        difference: the scalar fallback cannot price a fused device block,
        so the degraded regime is the *host-driven loop* instead — the same
        compiled chain step dispatched K=1 at a time with the carry pulled
        back between iterations. By the R=1-parity contract that replays
        the fused block bit-for-bit, so degradation changes dispatch
        granularity (and cost), never the search. The injector is consulted
        before every primary attempt (a vetoed attempt raises without
        submitting, and a ``ChainRequest`` re-dispatch is deterministic, so
        the retry prices an identical block); the degraded loop is never
        vetoed — degradation models recovery, not a second failure domain.
        Returns None iff the session was failed."""
        rp = self.retry
        fi = self.faults
        req: ChainRequest = session.pending
        backend = self.backend_for(session.request.tdg)
        if not hasattr(backend, "run_chains"):
            self._fail(session, DispatchFailed(
                f"session {session.name!r}: backend {backend.name!r} does "
                "not support device chain blocks"
            ))
            return None
        if not session.degraded:
            delay = rp.backoff_s
            last: Optional[BaseException] = None
            for attempt in range(rp.max_attempts):
                if session.n_consec_dispatch_failures >= rp.degrade_after:
                    break  # ladder exhausted: degrade instead of retrying
                if attempt > 0:
                    self.n_retries += 1
                    if delay > 0.0:
                        time.sleep(delay)
                    delay = min(delay * 2.0, rp.backoff_cap_s)
                try:
                    if fi is not None and fi.draw_dispatch_fault(session.name):
                        raise InjectedDispatchError(
                            f"injected dispatch fault: {session.name}"
                        )
                    block = backend.run_chains(req)
                    session.n_consec_dispatch_failures = 0
                    return block
                except Exception as exc:
                    self.n_dispatch_faults += 1
                    session.n_consec_dispatch_failures += 1
                    last = exc
            if session.n_consec_dispatch_failures < rp.degrade_after:
                self._fail(session, DispatchFailed(
                    f"session {session.name!r}: {rp.max_attempts} chain-"
                    f"block dispatch attempts failed (last: {last!r})"
                ))
                return None
            session.degraded = True
            self.n_degraded += 1
        # degraded regime: the host-loop schedule — K dispatches of the same
        # compiled step at k=1, carry round-tripped through host numpy
        # between iterations (the parity oracle's exact access pattern)
        try:
            import numpy as _np

            carry = req.carry
            block = None
            mvs, accs, fts = [], [], []
            for i in range(req.k):
                block = backend.run_chains(dataclasses.replace(
                    req, k=1, it0=req.it0 + i, carry=carry,
                ))
                carry = block.carry
                mvs.append(block.move_idx)
                accs.append(block.accepted)
                fts.append(block.fit_trace)
            block = dataclasses.replace(
                block,
                move_idx=_np.concatenate(mvs, axis=1),
                accepted=_np.concatenate(accs, axis=1),
                fit_trace=_np.concatenate(fts, axis=1),
            )
            return block
        except Exception as exc:
            self.n_dispatch_faults += 1
            self._fail(session, DispatchFailed(
                f"session {session.name!r}: degraded host-loop chain "
                f"dispatch failed ({exc!r})"
            ))
            return None

    # ---- the tick --------------------------------------------------------
    def tick(self) -> List[Session]:
        """One scheduler round: pack all live sessions' pending candidates
        per backend group, dispatch once per group, resume every member with
        its handle slice. Returns the sessions that completed this tick.

        The shared-dispatch wall is attributed to sessions proportionally to
        their candidate counts (the same accounting the lockstep Campaign
        loop reported as ``sim_wall_s``). Faults — injected or real — are
        quarantined per session; see the module docstring for the ladder."""
        completed: List[Session] = []
        if not self._live:
            return completed
        self.n_ticks += 1
        t_tick = time.perf_counter()
        fi = self.faults
        if fi is not None:
            fi.begin_tick(self.n_ticks)

        # deadline SLOs first: a session past its budget fails before it can
        # consume another dispatch
        for s in list(self._live):
            if s.past_deadline():
                self.n_deadline_exceeded += 1
                self._fail(s, DeadlineExceeded(
                    f"session {s.name!r} exceeded deadline_s="
                    f"{s.request.deadline_s}"
                ))

        # injected coroutine crashes (the chaos harness's process-death
        # stand-in) — thrown into the generator so the real unwind runs
        if fi is not None:
            for s in list(self._live):
                if fi.draw_crash(s.name):
                    escaped = s.crash(InjectedSessionCrash(
                        f"injected crash: session {s.name!r}"
                    ))
                    if escaped is not None:
                        self._recover(s, escaped, completed)
                    elif s.done:  # pragma: no cover — graceful wind-down
                        completed.append(s)
                        self._live.remove(s)

        # chain-batched sessions (config.chain_r > 0) carry a ChainRequest
        # instead of a candidate list: each is one fused (R, K) device block
        # already — there is nothing to pack, so they dispatch individually
        # through the SAME retry/degrade ladder as ordinary sessions
        # (_price_chain_session: backoff-capped retries, then the host-loop
        # regime as the degraded backend) and rejoin the ordinary pack only
        # for their final winner decode
        for s in list(self._live):
            if not isinstance(s.pending, ChainRequest):
                continue
            t0 = time.perf_counter()
            block = self._price_chain_session(s)
            if block is None:  # failed through the whole ladder
                continue
            s.sim_wall_s += time.perf_counter() - t0
            try:
                finished = s.resume([block])
            except Exception as exc:
                self._recover(s, exc, completed)
                continue
            if finished:  # pragma: no cover — final yield is a decode batch
                completed.append(s)
                self._live.remove(s)

        groups: Dict[int, List[Session]] = {}
        for s in self._live:
            if isinstance(s.pending, ChainRequest):
                continue  # failed resume above left no pack-able batch
            groups.setdefault(id(s.request.tdg), []).append(s)
        for members in groups.values():
            # degraded sessions price on the scalar fallback individually;
            # everyone else shares one device dispatch
            shared = [s for s in members if not s.degraded]
            priced: Dict[str, Optional[List[SimHandle]]] = {}
            if shared:
                backend = self.backend_for(shared[0].request.tdg)
                cands: List[Candidate] = [c for s in shared for c in s.pending]
                target = "shared:" + getattr(
                    shared[0].request.tdg, "name", str(id(shared[0].request.tdg))
                )
                t0 = time.perf_counter()
                try:
                    handles: Optional[List[SimHandle]] = self._attempt(
                        backend, cands, target, inject=True
                    )
                except Exception:
                    handles = None
                    self.n_dispatch_faults += 1
                    self.n_bisects += 1
                dispatch_s = time.perf_counter() - t0
                if handles is not None:
                    offset = 0
                    for s in shared:
                        k = len(s.pending)
                        priced[s.name] = handles[offset:offset + k]
                        offset += k
                        s.sim_wall_s += dispatch_s * k / max(len(cands), 1)
                        s.n_consec_dispatch_failures = 0
                else:
                    # bisect-and-redispatch: the poison (injected or a real
                    # mid-batch failure) is quarantined to whichever session
                    # owns it; survivors' redispatched rows are bit-identical
                    # to the shared rows (per-row independence)
                    for s in shared:
                        t1 = time.perf_counter()
                        priced[s.name] = self._price_session(s)
                        s.sim_wall_s += time.perf_counter() - t1
            for s in members:
                # degraded before this tick (mid-bisect degraders are
                # already in ``priced`` via their fallback redispatch)
                if s.degraded and s.state == RUNNING and s.name not in priced:
                    t1 = time.perf_counter()
                    priced[s.name] = self._price_session(s)
                    s.sim_wall_s += time.perf_counter() - t1

            for s in members:
                if s.state != RUNNING:
                    continue  # failed while pricing this very group
                handles = priced.get(s.name)
                if handles is None:
                    continue
                if fi is not None:
                    handles = fi.poison_rows(s.name, handles)
                try:
                    finished = s.resume(handles)
                except Exception as exc:
                    # satellite fix: a coroutine death no longer aborts the
                    # tick — quarantine (or crash-restart) that one session
                    self._recover(s, exc, completed)
                    continue
                if finished:
                    completed.append(s)
                    self._live.remove(s)

        st = self.monitor.record(self.n_ticks, time.perf_counter() - t_tick)
        if st.is_straggler:
            self.n_straggler_ticks += 1
        return completed

    def run_until_idle(self, max_ticks: Optional[int] = None) -> List[Session]:
        """Tick until no session is live (or ``max_ticks`` elapsed);
        returns everything that completed along the way."""
        done: List[Session] = []
        while self._live and (max_ticks is None or self.n_ticks < max_ticks):
            done.extend(self.tick())
        return done

    def flush(self) -> None:
        """Drain every shared backend's in-flight dispatches (batches a
        failed or finished session never consumed must not outlive the
        serve loop)."""
        for backend in self._backends.values():
            flush = getattr(backend, "flush", None)
            if flush is not None:
                flush()
