"""Serve layer: multi-tenant continuous-batching DSE on one shared backend.

This package hosts many concurrent exploration **sessions** (each a
policy-driven :class:`~repro_torch.core.explorer.Explorer` coroutine) on top
of one shared :class:`~repro_torch.core.backend.TorchBatchedBackend` per
workload, pricing on the card through the CUDA phase-sim kernel
(``device="cpu"`` runs its plain PyTorch version):

  ``DesignStore``               — content-addressed evaluation cache keyed on
                                  ``hash(EncodedDesign leaves, workload,
                                  budget)`` so identical evaluations resolve
                                  to memoized rows without a dispatch.
  ``Session`` / ``SessionRequest`` — one exploration request wrapped around
                                  the ``Explorer.run_steps`` coroutine, with
                                  streamed best-design events.
  ``ContinuousBatchScheduler``  — generalizes ``Campaign``'s lockstep
                                  cross-batching: sessions join and leave
                                  mid-flight; every tick packs all ready
                                  candidates into the shape-bucketed device
                                  batches.
  ``DseService``                — the front door: submit sessions, drive
                                  ticks, read streamed events and final
                                  results, and aggregate service stats.

The fault-tolerance layer (``faults``) adds a seeded chaos harness
(``FaultInjector``), session-level isolation (a ``FAILED`` lifecycle state,
bisect-and-redispatch of poisoned shared batches), retry/backoff +
per-session deadlines, and graceful per-session degradation to the scalar
backend; see the "Fault tolerance" section of docs/SERVING.md.
"""
from .faults import (
    DeadlineExceeded,
    DispatchFailed,
    FaultInjector,
    InjectedDispatchError,
    InjectedSessionCrash,
    InjectedFault,
    RetryPolicy,
    SessionFailed,
)
from .scheduler import ContinuousBatchScheduler
from .service import DseService, ServiceStats, SessionHandle
from .session import BestEvent, Session, SessionRequest
from .store import DesignStore, StoreStats

__all__ = [
    "BestEvent",
    "ContinuousBatchScheduler",
    "DeadlineExceeded",
    "DesignStore",
    "DispatchFailed",
    "DseService",
    "FaultInjector",
    "InjectedDispatchError",
    "InjectedFault",
    "InjectedSessionCrash",
    "RetryPolicy",
    "ServiceStats",
    "Session",
    "SessionFailed",
    "SessionHandle",
    "SessionRequest",
    "StoreStats",
]
