"""Pluggable simulation backends: one batched ``evaluate`` API.

The paper's headline claim is an *agile* simulator driving the DSE, and its
own profile (Fig. 8) puts 79.9% of exploration time in design evaluation
overhead. This module makes the evaluator a pluggable component behind a
single batched interface so the search loop never cares how a design is
priced:

  ``PythonBackend``       — the reference phase-driven simulator
                            (`phase_sim.simulate`), one design at a time.
  ``TorchBatchedBackend`` — flat-array encodings priced in one dispatch per
                            batch: the CUDA phase-sim kernel on the card, its
                            plain PyTorch version on the CPU. Row buffers are
                            keyed on power-of-two padded slot/batch/NoC-chain
                            shapes. Multi-NoC chains are encoded natively; the
                            per-design fallback to the Python path remains
                            only for shapes the encoding cannot host
                            (``UnsupportedDesignError`` — chains beyond
                            ``phase_sim_torch.MAX_NOC``).

The DSE hot path is :meth:`evaluate_candidates`: the explorer submits
lightweight :class:`Candidate` records (base design + recorded move delta —
no cloned object graphs), the backend applies each delta onto the cached
encoding of the base (`phase_sim_torch.apply_delta`) inside persistent
preallocated shape-bucket buffers, and one non-blocking dispatch returns
:class:`SimHandle` objects. A handle's Eq.-7 ``fitness`` (computed on
device) and scalar PPA columns are one small host transfer for the whole
batch; the full ``SimResult`` (per-task finish/bottleneck/energy dicts) is
reconstructed lazily on first ``result()`` — only the candidate the explorer
accepts ever pays the decode.

With a ``serve.DesignStore`` attached (:meth:`TorchBatchedBackend.attach_store`)
a candidate whose encoding, workload and budget were priced before is served
from the memoized row, bit-identically, without a dispatch.

``evaluate(designs)`` stays as the eager compatibility wrapper (it decodes
everything). Simulation-count and wall-clock accounting live here, in
``BackendStats``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from .blocks import BlockKind
from .budgets import Budget, Distance, distance
from .database import HardwareDatabase
from .design import Design
from .moves import MoveDelta, MoveSpec, apply_spec
from .phase_sim import SimResult, simulate
from .scal_layout import (
    KIND_START as _KIND_START,
    KIND_STOP as _KIND_STOP,
    SCAL_PREFIX as _SCAL_COLS,
    TOP_MEM_COL as _TOP_MEM_COL,
    TOP_PE_COL as _TOP_PE_COL,
)
from .ppa import total_leakage_w
from .tdg import TaskGraph, workload_of

_BNECK_KINDS = ("pe", "mem", "noc")


@dataclasses.dataclass
class BackendStats:
    """Evaluation accounting — the backend owns n_sims and sim wall-clock.

    ``wall_s`` covers time inside ``evaluate``/``evaluate_candidates``;
    the encode/dispatch/decode breakdown splits the batched hot path: host-side
    delta encoding into the batch buffers, kernel dispatch submission (async —
    device time is hidden behind it), and lazy ``SimResult`` reconstruction
    (paid per *accessed* handle, possibly after the dispatch returns, so
    ``decode_s`` is not a subset of ``wall_s``).

    ``n_inflight_max`` is the deepest the dispatch pipeline ever got: the
    number of dispatches simultaneously un-consumed on device. ≥ 2 means a
    later batch was encoded+submitted while an earlier one was still being
    scored — the host-encode/device-compute overlap multi-session serving
    relies on (many sessions' batches in flight at once)."""

    n_sims: int = 0  # designs evaluated (cache-served candidates included)
    n_dispatches: int = 0  # evaluate() calls
    n_batched: int = 0  # designs through the vectorized path
    n_fallback: int = 0  # designs through the scalar Python path
    n_compiles: int = 0  # distinct padded shape keys (row buffers built)
    n_inflight_max: int = 0  # deepest concurrent-dispatch pipeline seen
    # content-addressed evaluation cache counters (serve.DesignStore; zero
    # unless a store is attached): hits served from a memoized row or a
    # same-dispatch alias, misses dispatched and registered, bypasses for
    # scalar-fallback candidates
    n_cache_hits: int = 0
    n_cache_misses: int = 0  # rows dispatched and registered in the store
    n_cache_bypass: int = 0
    # rows whose device fitness came back NaN/Inf at the host scal pull —
    # the serve layer's non-finite guard rejects these; a nonzero count on a
    # healthy backend means a numerical escape worth investigating
    n_nonfinite_rows: int = 0
    wall_s: float = 0.0  # total time inside evaluate()
    encode_s: float = 0.0  # incremental encoding into batch buffers
    dispatch_s: float = 0.0  # H2D copy + kernel launch + D2H enqueue
    decode_s: float = 0.0  # lazy SimResult reconstruction + score fetches


@dataclasses.dataclass
class Candidate:
    """One design to price: a shared *base* design plus an optional recorded
    move. The move is replayed (``apply_spec``) only when a full ``Design``
    is needed — python fallback, lazy decode, or explorer acceptance; the
    vectorized path prices the candidate straight from ``delta`` without
    ever materializing the object graph."""

    base: Design
    spec: Optional[MoveSpec] = None
    delta: Optional[MoveDelta] = None
    budget: Optional[Budget] = None  # enables device-side Eq.-7 fitness
    alpha: float = 0.05

    @staticmethod
    def of_design(design: Design, budget: Optional[Budget] = None,
                  alpha: float = 0.05) -> "Candidate":
        return Candidate(base=design, budget=budget, alpha=alpha)

    def vectorizable(self) -> bool:
        """True when the *resulting* design stays inside the encodable
        regime (a chain of at most ``phase_sim_torch.MAX_NOC`` NoCs) and (for
        moved candidates) the delta path can encode it — topology moves
        included, since NoC fork/join record chain/attachment edits."""
        from .phase_sim_torch import MAX_NOC

        n = len(self.base.noc_chain)
        if self.spec is not None:
            if self.delta is None or self.delta.topology:
                return False
            blocks = self.base.blocks
            for b in self.delta.added:
                n += b.kind == BlockKind.NOC
            for name in self.delta.removed:
                blk = blocks.get(name)
                n -= blk is not None and blk.kind == BlockKind.NOC
        return 1 <= n <= MAX_NOC

    def _replay(self, tdg: TaskGraph) -> None:
        """Replay the recorded move, then rename any block the replay minted
        back to the name recorded in the delta: every materialization of
        this candidate — pricing fallback, lazy decode, and the final
        ``accept`` — must agree on block names, or the decoded
        ``SimResult``'s per-task block references would dangle in the
        accepted design."""
        before = None
        if self.delta is not None and self.delta.added:
            before = set(self.base.blocks)
        ok = apply_spec(self.base, tdg, self.spec)
        assert ok, f"recorded move failed to replay: {self.spec}"
        if before is not None:
            minted = [n for n in self.base.blocks if n not in before]
            for fresh, rec in zip(minted, self.delta.added):
                if fresh != rec.name:
                    self.base.rename_block(fresh, rec.name)

    @contextlib.contextmanager
    def materialized(self, tdg: TaskGraph) -> Iterator[Design]:
        """Temporarily turn the candidate into a real ``Design`` (apply the
        recorded move in place, roll back on exit). The base must be in the
        state it had when the move was recorded — the explorer guarantees
        that by materializing/accepting before mutating ``cur``."""
        if self.spec is None:
            yield self.base
            return
        ck = self.base.checkpoint()
        self._replay(tdg)
        try:
            yield self.base
        finally:
            self.base.restore(ck)

    def accept(self, tdg: TaskGraph) -> None:
        """Apply the recorded move to the base permanently (the one full
        materialization the whole batch pays)."""
        if self.spec is not None:
            self._replay(tdg)


@runtime_checkable
class SimHandle(Protocol):
    """Lazy result of pricing one candidate."""

    @property
    def fitness(self) -> float:
        """Eq.-7 distance-to-budget fitness (requires Candidate.budget)."""
        ...

    def scalars(self) -> Dict[str, float]:
        """Cheap PPA columns: latency_s / power_w / area_mm2 (no decode)."""
        ...

    def result(self) -> SimResult:
        """Full SimResult; reconstructed on first access."""
        ...

    def telemetry(self) -> "SimTelemetry":
        """Selection-grade view (device bottleneck columns + Eq.-7
        distance) — what the heuristic-policy layer reasons over instead of
        a full decode. Same validity contract as ``result()``: the
        candidate's base design must be in its priced (pre-accept) state."""
        ...

    def result_for(self, design: Design) -> SimResult:
        """Decode against an explicitly provided materialized design — for
        consumers (the explorer's final best-design decode) that read a
        handle long after the candidate's base has mutated past it."""
        ...


@runtime_checkable
class SimulatorBackend(Protocol):
    """Anything that prices a batch of designs for one task graph."""

    name: str
    tdg: TaskGraph
    db: HardwareDatabase

    def evaluate(self, designs: Sequence[Design]) -> List[SimResult]:
        """Simulate every design eagerly; results align with the input order."""
        ...

    def evaluate_candidates(self, cands: Sequence[Candidate]) -> List[SimHandle]:
        """Price a batch of candidates, returning lazy handles — the DSE hot
        path. The call is NON-BLOCKING on asynchronous backends (it returns
        once the dispatch is submitted; nothing crosses the device boundary
        until a handle is read), so several batches may be in flight at
        once. ``flush()`` is the only way to wait without consuming."""
        ...

    def flush(self) -> None:
        """Block until every in-flight dispatch has finished scoring.
        Synchronous backends are already drained — no-op. Call it before
        tearing a backend down or timing device work; reading any handle of
        a batch also implicitly completes that batch."""
        ...

    def supports(self, design: Design) -> bool:
        """True if ``design`` takes the backend's fast path (capability hook;
        unsupported designs must still evaluate correctly via fallback)."""
        ...

    def stats(self) -> BackendStats:
        ...


class _ReadyHandle:
    """Handle over an already-decoded SimResult (python path / fallbacks).

    Carries its candidate so ``adopt_encoding`` can tell WHOSE cached base
    encoding to invalidate when a fallback-priced move gets accepted."""

    __slots__ = ("_res", "_fitness", "_cand", "_tdg")

    def __init__(self, res: SimResult, fitness: float,
                 cand: Optional[Candidate] = None,
                 tdg: Optional[TaskGraph] = None) -> None:
        self._res = res
        self._fitness = fitness
        self._cand = cand
        self._tdg = tdg

    @property
    def fitness(self) -> float:
        return self._fitness

    def scalars(self) -> Dict[str, float]:
        return {
            "latency_s": self._res.latency_s,
            "power_w": self._res.power_w,
            "area_mm2": self._res.area_mm2,
        }

    def result(self) -> SimResult:
        return self._res

    def result_for(self, design: Design) -> SimResult:
        return self._res  # already decoded; the design played no further part

    def telemetry(self) -> "SimTelemetry":
        assert self._tdg is not None, "handle was built without its TaskGraph"
        design = self._cand.base if self._cand is not None else None
        return SimTelemetry.of_result(self._res, self._tdg, design)


def _host_fitness(res: SimResult, cand: Candidate) -> float:
    if cand.budget is None:
        return float("nan")
    return distance(res, cand.budget).fitness(cand.alpha)


class _PPAView:
    """Duck-typed stand-in for the three SimResult fields `budgets.distance`
    reads — lets a telemetry view reuse the one true Eq.-7 distance code."""

    __slots__ = ("workload_latency_s", "power_w", "area_mm2")

    def __init__(self, wl: Dict[str, float], power: float, area: float) -> None:
        self.workload_latency_s = wl
        self.power_w = power
        self.area_mm2 = area


class SimTelemetry:
    """Selection-grade view of one priced candidate — the input the
    heuristic-policy layer (`repro_torch.core.policy`) reasons over.

    It exposes (a) the device-side bottleneck telemetry columns — per-block
    binding-bottleneck seconds, the argmax ("top bottleneck") PE/MEM block,
    and the comp-vs-comm attribution split — and (b) the per-task /
    per-metric accessors FARSI's selection reasoning needs (task durations,
    per-task dynamic energy, memory residency, per-task binding resource),
    plus the Eq.-7 ``Distance``. What it does NOT do is materialize the full
    ``SimResult`` dict set: on the torch backend a view is a handful of
    zero-copy column reads plus an O(T) host scalar rollup, which is what
    makes the winner's full ``_decode`` policy-optional.

    Built either over an already-decoded ``SimResult`` (`of_result` — the
    Python backend and fallback-priced candidates; every accessor proxies
    the result, so policies see bit-identical floats on either backend) or
    over one row of a torch batch's host columns (`of_row`). Row-backed
    construction snapshots the task→block maps and recomputes the
    design-dependent scalars (energy, power, area, capacities) exactly as
    the lazy decode would — shared backend helpers — so telemetry-driven
    searches take the same decisions as decode-driven ones (asserted by the
    golden-sequence policy-equivalence tests). Construction has the same
    contract as ``SimHandle.result()``: the candidate's base design must
    still be in its priced state."""

    __slots__ = (
        "_tdg", "_res", "_design",
        "latency_s", "power_w", "area_mm2",
        "_wl_lat", "_tep", "_cap",
        "_fin", "_index", "_codes", "_task_pe", "_task_mem", "_nocs",
        "_pe_names", "_mem_names", "_pe_busy", "_mem_busy", "_noc_busy",
        "_kind", "_top_pe", "_top_mem",
    )

    # ---- births ----------------------------------------------------------
    @staticmethod
    def of_result(res: SimResult, tdg: TaskGraph,
                  design: Optional[Design] = None) -> "SimTelemetry":
        t = SimTelemetry()
        t._tdg, t._res, t._design = tdg, res, design
        t.latency_s = res.latency_s
        t.power_w = res.power_w
        t.area_mm2 = res.area_mm2
        t._top_pe = t._top_mem = None  # resolved lazily through the design
        return t

    @staticmethod
    def of_row(batch: "_TorchBatch", j: int, cand: Candidate,
               backend: "TorchBatchedBackend") -> "SimTelemetry":
        out = batch.host()  # forces the batch, like any first handle read
        t = SimTelemetry()
        t._tdg, t._res, t._design = backend.tdg, None, cand.base
        t._index = backend._enc.index
        t._fin = out["finish_s"][j].tolist()
        t._codes = out["bneck_code"][j]
        t._kind = out["bneck_kind_s"][j]
        t._pe_busy = out["pe_bneck_s"][j]
        t._mem_busy = out["mem_bneck_s"][j]
        t._noc_busy = out["noc_bneck_s"][j]
        t.latency_s = float(out["latency_s"][j])
        # design-dependent snapshot: the base design is only guaranteed to be
        # in the priced state NOW, so task→block maps and the host-exact
        # scalar rollup (the same floats the lazy decode would produce) are
        # captured at construction; everything else indexes device columns
        with cand.materialized(backend.tdg) as design:
            t._tep = backend._task_energy_pj(design)
            t._cap = backend._mem_caps(design)
            t.area_mm2 = backend._area_mm2(design, t._cap)
            energy = sum(t._tep.values()) * 1e-12 + total_leakage_w(
                design, backend.db
            ) * t.latency_s
            t.power_w = energy / t.latency_s if t.latency_s > 0 else 0.0
            t._task_pe = dict(design.task_pe)
            t._task_mem = dict(design.task_mem)
            t._nocs = list(design.noc_chain)
            t._pe_names = [n for n, b in design.blocks.items()
                           if b.kind == BlockKind.PE]
            t._mem_names = [n for n, b in design.blocks.items()
                            if b.kind == BlockKind.MEM]
        t._wl_lat = backend._wl_latency(t._fin)
        t._top_pe = t._pe_names[
            min(int(out["top_bneck_pe"][j]), len(t._pe_names) - 1)]
        t._top_mem = t._mem_names[
            min(int(out["top_bneck_mem"][j]), len(t._mem_names) - 1)]
        return t

    # ---- Eq.-7 distance --------------------------------------------------
    def dist(self, budget: Budget) -> Distance:
        if self._res is not None:
            return distance(self._res, budget)
        return distance(_PPAView(self._wl_lat, self.power_w, self.area_mm2),
                        budget)

    # ---- per-task selection accessors ------------------------------------
    def task_finish_s(self, t: str) -> float:
        if self._res is not None:
            return self._res.task_finish_s.get(t, 0.0)
        return self._fin[self._index[t]]

    def task_duration(self, t: str) -> float:
        """Critical-path duration contribution: finish − latest parent
        finish (what `_task_duration` computed from a decoded result)."""
        start = max(
            (self.task_finish_s(p) for p in self._tdg.parents[t]), default=0.0
        )
        return self.task_finish_s(t) - start

    def task_energy_j(self, t: str) -> float:
        if self._res is not None:
            return self._res.task_energy_j.get(t, 0.0)
        return self._tep.get(t, 0.0) * 1e-12

    def mem_capacity(self, m: str) -> float:
        if self._res is not None:
            return self._res.mem_capacity_bytes.get(m, 0.0)
        return self._cap.get(m, 0.0)

    def task_bneck(self, t: str) -> str:
        if self._res is not None:
            return self._res.task_bottleneck.get(t, "pe")
        # codes are packed: 0/1 = pe/mem, 2 + 3·k = NoC at chain index k
        return _BNECK_KINDS[min(int(self._codes[self._index[t]]), 2)]

    def task_bneck_block(self, t: str) -> Optional[str]:
        if self._res is not None:
            return self._res.task_bottleneck_block.get(t)
        c = int(self._codes[self._index[t]])
        return self._task_pe[t] if c == 0 else (
            self._task_mem[t] if c == 1 else self._nocs[(c - 2) // 3]
        )

    # ---- device bottleneck telemetry -------------------------------------
    @property
    def comp_s(self) -> float:
        """Seconds some running task was compute-bound (kind column 'pe')."""
        if self._res is not None:
            return self._res.bottleneck_s.get("pe", 0.0)
        return float(self._kind[0])

    @property
    def comm_s(self) -> float:
        """Seconds some running task was communication-bound (mem + noc)."""
        if self._res is not None:
            b = self._res.bottleneck_s
            return b.get("mem", 0.0) + b.get("noc", 0.0)
        return float(self._kind[1] + self._kind[2])

    def _top_of_kind(self, kind: BlockKind) -> Optional[str]:
        if self._design is None:
            return None
        best, best_s = None, -1.0
        for n, b in self._design.blocks.items():
            if b.kind == kind:
                s = self._res.block_bottleneck_s.get(n, 0.0)
                if s > best_s:
                    best, best_s = n, s
        return best

    def top_bneck_pe(self) -> Optional[str]:
        """The PE accumulating the most binding-bottleneck seconds — the
        device argmax column on the torch backend, the host attribution otherwise."""
        if self._top_pe is None and self._res is not None:
            self._top_pe = self._top_of_kind(BlockKind.PE)
        return self._top_pe

    def top_bneck_mem(self) -> Optional[str]:
        if self._top_mem is None and self._res is not None:
            self._top_mem = self._top_of_kind(BlockKind.MEM)
        return self._top_mem

    def block_bneck_s(self) -> Dict[str, float]:
        """Per-block binding-bottleneck seconds (name-resolved)."""
        if self._res is not None:
            return dict(self._res.block_bottleneck_s)
        out = {n: float(self._pe_busy[i]) for i, n in enumerate(self._pe_names)}
        out.update(
            (n, float(self._mem_busy[i])) for i, n in enumerate(self._mem_names)
        )
        out.update(
            (n, float(self._noc_busy[i])) for i, n in enumerate(self._nocs)
        )
        return out


class PythonBackend:
    """Scalar reference path: `phase_sim.simulate` per design."""

    name = "python"
    async_dispatch = False  # evaluates inline: nothing to pipeline behind

    def __init__(self, tdg: TaskGraph, db: HardwareDatabase) -> None:
        self.tdg = tdg
        self.db = db
        self._stats = BackendStats()

    def supports(self, design: Design) -> bool:
        return True

    def flush(self) -> None:
        """Synchronous backend: every evaluate() already returned results."""

    def evaluate(self, designs: Sequence[Design]) -> List[SimResult]:
        t0 = time.perf_counter()
        out = [simulate(d, self.tdg, self.db) for d in designs]
        self._stats.n_sims += len(out)
        self._stats.n_dispatches += 1
        self._stats.wall_s += time.perf_counter() - t0
        return out

    def evaluate_candidates(self, cands: Sequence[Candidate]) -> List[SimHandle]:
        t0 = time.perf_counter()
        out: List[SimHandle] = []
        for c in cands:
            with c.materialized(self.tdg) as d:
                res = simulate(d, self.tdg, self.db)
            out.append(_ReadyHandle(res, _host_fitness(res, c), c, self.tdg))
        self._stats.n_sims += len(out)
        self._stats.n_dispatches += 1
        self._stats.wall_s += time.perf_counter() - t0
        return out

    def stats(self) -> BackendStats:
        return self._stats


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _bucket(n: int) -> int:
    """Padded-size bucket: power of two, floored at 4. A near-constant shape
    space (slots and batch rarely leave {4, 8, 16, 32, 64}) keeps the row
    buffers few — but the floor matters on the batch axis: the explorer's
    neighbour batches are ≤ 4 candidates, and padding them to 8 would double
    the rows every serial iteration prices."""
    return max(4, _pow2(n))


def _buffer_key(b: int, slots: int, n_noc: int) -> Tuple[int, int, int]:
    """The row-buffer key of a dispatch of ``b`` candidates needing
    ``slots`` slot columns (at least the task count) and ``n_noc`` NoCs:
    batch and slots bucketed, the NoC chain to a power of two without a
    floor. ``n_compiles`` counts these keys."""
    return _bucket(b), _bucket(slots), max(1, _pow2(n_noc))


def resolve_device(device=None) -> torch.device:
    """The device a batched backend prices on: the card unless the caller
    names another. Asking for CUDA where there is none raises — pricing
    never drops to the CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to price with the "
            "plain PyTorch version"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no phase-sim path for device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # name the card as its tensors report it (cuda:N), so the workload
        # copy made here is the one every dispatch finds
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_ALIGN = 16  # byte alignment of every array inside a row buffer


class _RowBuffer:
    """One shape bucket's padded rows: host arrays + their device twin.

    Every row array is a view into ONE byte buffer, so a dispatch moves its
    whole batch with a single copy. The four per-candidate scalars of
    ``NOCS_COLS`` share one ``(B, 4)`` block (the kernel's packed input);
    the rows dict exposes its columns, so ``fill_row``/``fill_budget`` write
    it in place. On CUDA the host buffer is pinned and the copy to the
    device buffer is non-blocking; ``h2d`` is the event recorded right after
    that copy — the host side must not be refilled before it fires. On the
    CPU the "device" views alias the host buffer."""

    __slots__ = ("rows", "dev", "nocs", "host_bytes", "dev_bytes", "h2d")

    def __init__(self, b: int, t: int, slots: int, n_wl: int, n_noc: int,
                 device: torch.device) -> None:
        from ..kernels.phase_sim.kernel import NOCS_COLS
        from .phase_sim_torch import alloc_rows

        spec = alloc_rows(b, t, slots, slots, n_wl, n_noc)
        nocs0 = np.stack([spec.pop(k) for k in NOCS_COLS], 1)  # (B, 4) f32
        spec["nocs"] = nocs0
        offs: Dict[str, int] = {}
        total = 0
        for k, a in spec.items():
            offs[k] = total
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        cuda = device.type == "cuda"
        host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        devb = torch.empty(total, dtype=torch.uint8, device=device) if cuda else host
        hnp = host.numpy()
        self.rows: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        for k, a in spec.items():
            o = offs[k]
            view = hnp[o:o + a.nbytes].view(a.dtype).reshape(a.shape)
            view[...] = a
            tdt = torch.from_numpy(a[:0]).dtype
            dview = devb[o:o + a.nbytes].view(tdt).view(a.shape)
            if k == "nocs":
                self.nocs = dview
                for i, c in enumerate(NOCS_COLS):
                    self.rows[c] = view[:, i]
                    self.dev[c] = dview[:, i]
            else:
                self.rows[k] = view
                self.dev[k] = dview
        self.host_bytes = host
        self.dev_bytes = devb
        self.h2d: Optional[torch.cuda.Event] = None

    def wait_reusable(self) -> None:
        """Block until the last H2D copy out of the host side has finished
        (a no-op when it already has, and on the CPU)."""
        if self.h2d is not None and not self.h2d.query():
            self.h2d.synchronize()

    def upload(self) -> None:
        if self.dev_bytes is not self.host_bytes:
            self.dev_bytes.copy_(self.host_bytes, non_blocking=True)
            self.h2d = torch.cuda.Event()
            self.h2d.record()


class _TorchBatch:
    """Shared state of one dispatch: the packed result rows + one memoized
    host view.

    The dispatch is non-blocking — on CUDA the result rows are copied into
    pinned host memory by a non-blocking D2H enqueued right after the
    kernel, followed by the ``done`` event. The first consumer (any
    handle's ``fitness``) waits on that event once and unpacks the rows
    into the standard output keys as zero-copy column views: one
    host↔device sync per batch. ``consumed`` flips on the pull — the backend
    uses it to retire the batch from its in-flight pipeline accounting."""

    __slots__ = ("out", "done", "stats", "eds", "layout", "t", "_host", "consumed")

    def __init__(self, out: torch.Tensor, done, stats: BackendStats, eds,
                 layout: Dict[str, int], t: int) -> None:
        self.out = out  # (B_pad, width) f32 on the host (pinned on CUDA)
        self.done = done  # CUDA event after the D2H copy; None on the CPU
        self.stats = stats
        self.eds = eds  # per-row EncodedDesign (for adopt_encoding)
        self.layout = layout
        self.t = t
        self._host: Optional[Dict[str, np.ndarray]] = None
        self.consumed = False

    def ready(self) -> bool:
        return self.done is None or self.done.query()

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()

    def host(self) -> Dict[str, np.ndarray]:
        """The whole batch output on host, unpacked into the standard
        output keys as zero-copy column views."""
        if self._host is None:
            t0 = time.perf_counter()
            self.wait()
            raw = self.out.numpy()
            lay, t = self.layout, self.t
            host = {name: raw[:, i] for i, name in enumerate(_SCAL_COLS)}
            host["bneck_kind_s"] = raw[:, _KIND_START:_KIND_STOP]
            host["top_bneck_pe"] = raw[:, _TOP_PE_COL]
            host["top_bneck_mem"] = raw[:, _TOP_MEM_COL]
            host["pe_bneck_s"] = raw[:, lay["pe"]:lay["mem"]]
            host["mem_bneck_s"] = raw[:, lay["mem"]:lay["noc"]]
            host["noc_bneck_s"] = raw[:, lay["noc"]:lay["scal_end"]]
            host["finish_s"] = raw[:, lay["finish"]:lay["finish"] + t]
            host["bneck_code"] = raw.view(np.int32)[:, lay["bneck"]:lay["bneck"] + t]
            # non-finite guard accounting: a NaN/Inf fitness row is the
            # device-side symptom the serve layer must never accept (real
            # rows only — the pow2 pad rows replicate row 0)
            fit = host["fitness"][: len(self.eds)]
            bad = int(np.size(fit) - np.count_nonzero(np.isfinite(fit)))
            if bad:
                self.stats.n_nonfinite_rows += bad
            self._host = host
            self.consumed = True
            self.stats.decode_s += time.perf_counter() - t0
        return self._host

    def fitness(self) -> np.ndarray:
        return self.host()["fitness"]


class _CachedBatch:
    """Duck-typed one-row ``_TorchBatch`` over a memoized store row.

    A `serve.DesignStore` hit serves a candidate from the host columns of an
    earlier identical evaluation. Wrapping that row (leading axis 1) behind
    the ``host()/fitness()`` batch interface lets the ordinary
    ``_TorchHandle`` machinery — fitness, scalars, telemetry, lazy decode,
    ``adopt_encoding`` — read it through the exact same code path as a fresh
    dispatch, so a cache hit is bit-identical to the dispatch it memoized.
    ``eds`` carries the *consumer's* encoding (computed anyway to derive the
    cache key): the producer's encoding may map different block names onto
    the same arrays, and adoption must stay keyed to the consumer's own
    design."""

    __slots__ = ("_row", "stats", "eds", "consumed")

    def __init__(self, row: Dict[str, np.ndarray], stats: BackendStats, ed) -> None:
        self._row = row
        self.stats = stats
        self.eds = [ed]
        self.consumed = True  # nothing in flight: the row is already host-side

    def host(self) -> Dict[str, np.ndarray]:
        return self._row

    def fitness(self) -> np.ndarray:
        return self._row["fitness"]


class _TorchHandle:
    """Lazy handle into one row of a `_TorchBatch` (or a `_CachedBatch`)."""

    __slots__ = ("_batch", "_j", "_cand", "_backend", "_res", "_ed")

    def __init__(self, batch: _TorchBatch, j: int, cand: Candidate, backend,
                 ed=None) -> None:
        self._batch = batch
        self._j = j
        self._cand = cand
        self._backend = backend
        self._res: Optional[SimResult] = None
        # adoption override: a row shared across candidates (same-dispatch
        # cache alias) carries THIS consumer's encoding here — the row
        # owner's `eds[j]` may map different block names to the same arrays
        self._ed = ed

    @property
    def fitness(self) -> float:
        return float(self._batch.fitness()[self._j])

    def scalars(self) -> Dict[str, float]:
        s = self._batch.host()
        return {k: float(s[k][self._j]) for k in ("latency_s", "power_w", "area_mm2")}

    def result(self) -> SimResult:
        if self._res is None:
            t0 = time.perf_counter()
            with self._cand.materialized(self._backend.tdg) as design:
                self._res = self._decode_against(design)
            self._batch.stats.decode_s += time.perf_counter() - t0
        return self._res

    def result_for(self, design: Design) -> SimResult:
        """Decode against a caller-provided materialized design (e.g. the
        explorer's best-design snapshot, long after the candidate's base
        moved on). Bypasses — and does not populate — the memoized
        ``result()``."""
        t0 = time.perf_counter()
        res = self._decode_against(design)
        self._batch.stats.decode_s += time.perf_counter() - t0
        return res

    def _decode_against(self, design: Design) -> SimResult:
        out, j = self._batch.host(), self._j
        return self._backend._decode(
            design,
            float(out["latency_s"][j]),
            out["finish_s"][j],
            out["bneck_code"][j],
            out["bneck_kind_s"][j],
            out["pe_bneck_s"][j],
            out["mem_bneck_s"][j],
            out["noc_bneck_s"][j],
            float(out["alp_time_s"][j]),
            float(out["traffic_bytes"][j]),
            int(out["n_phases"][j]),
        )

    def telemetry(self) -> SimTelemetry:
        t0 = time.perf_counter()
        tel = SimTelemetry.of_row(self._batch, self._j, self._cand, self._backend)
        self._batch.stats.decode_s += time.perf_counter() - t0
        return tel


class TorchBatchedBackend:
    """One batched dispatch per batch of candidates (multi-NoC included).

    Latency/finish times and the Eq.-7 fitness come from the phase-sim
    kernel; the rest of ``SimResult`` is reconstructed exactly on the host,
    lazily: PPA rollups are O(blocks) closed forms, and per-task dynamic
    energy depends only on total drained work (every task runs to
    completion) and its route hop count, not on phase rates. Chain
    topologies are encoded natively up to ``phase_sim_torch.MAX_NOC`` NoCs;
    only shapes the encoding cannot host (``UnsupportedDesignError``) fall
    back to the Python simulator per design, inside the same
    ``evaluate_candidates`` call.

    The device picks the formulation, and nothing else does: on CUDA every
    dispatch launches the CUDA kernel (``repro_torch.kernels.phase_sim``);
    on the CPU the same call runs its plain PyTorch version. ``device=None``
    means the card, and raises where there is none.

    Dispatch is asynchronous on the card: ``evaluate_candidates`` returns
    after one H2D copy, the kernel launch and one D2H copy are enqueued;
    host row buffers are double-buffered per shape bucket and a buffer is
    refilled only after the event recorded behind its last H2D copy fired;
    ``flush()`` drains whatever is outstanding."""

    name = "torch"
    async_dispatch = True  # dispatch returns before the device scores it

    def __init__(self, tdg: TaskGraph, db: HardwareDatabase, device=None) -> None:
        from .phase_sim_torch import EncodedWorkload

        self.device = resolve_device(device)
        self.tdg = tdg
        self.db = db
        self._enc = EncodedWorkload.of(tdg)
        self._enc.on(self.device)  # the workload moves to the device once
        # shape bucket -> two alternating row buffers (double-buffered so a
        # fresh encode never overwrites what a pending H2D still reads)
        self._buffers: Dict[tuple, List[Optional[_RowBuffer]]] = {}
        self._bufsel: Dict[tuple, int] = {}
        # (bucket, buffer-slot) -> (base_ed, budget, alpha, dirty cells)
        # enabling the steady-state restore-only refill (see _evaluate_batch)
        self._buf_state: Dict[tuple, tuple] = {}
        self._inflight: List[_TorchBatch] = []
        # id(design) -> (design, EncodedDesign) adopted via adopt_encoding;
        # the design ref doubles as an identity guard against id() reuse
        self._adopted: Dict[int, tuple] = {}
        self._shapes: set = set()
        self._stats = BackendStats()
        self._chains = None  # the DeviceChainRunner, built at first use
        # content-addressed evaluation cache (serve.DesignStore) — opt-in
        # via attach_store(); None keeps the uncached behaviour
        self._store = None
        self._wl_digest: Optional[bytes] = None
        # static per-task tables for host-side SimResult reconstruction:
        # totals are design-independent; only the block subtype scales energy
        names = self._enc.names
        self._ops = [float(tdg.tasks[n].work_ops) for n in names]
        self._rw = [float(tdg.tasks[n].read_bytes + tdg.tasks[n].write_bytes) for n in names]
        self._wbytes = [float(tdg.tasks[n].write_bytes) for n in names]
        self._wl_of = [workload_of(n) if "." in n else tdg.name for n in names]
        e = db.energy
        self._pe_pj = {"acc": e.acc_pj_per_op, "gpp": e.gpp_pj_per_op}
        self._mem_pj = {"sram": e.sram_pj_per_byte, "dram": e.dram_pj_per_byte}
        self._noc_pj = e.noc_pj_per_byte_hop

    def supports(self, design: Design) -> bool:
        from .phase_sim_torch import MAX_NOC

        return 1 <= len(design.noc_chain) <= MAX_NOC

    def stats(self) -> BackendStats:
        return self._stats

    def attach_store(self, store) -> None:
        """Attach a content-addressed evaluation cache (`serve.DesignStore`).
        Every subsequent vectorizable candidate is keyed on
        ``hash(EncodedDesign leaves, workload, budget)``: key hits are served
        from the memoized row of an earlier identical evaluation (no device
        row dispatched — bit-identical scalars, see ``_CachedBatch``),
        duplicate keys *within* one batch alias a single dispatched row, and
        every freshly dispatched row is registered for future sessions. The
        store may be shared across backends/workloads (the workload digest
        namespaces the keys)."""
        self._store = store
        self._wl_digest = store.workload_digest(self._enc) if store is not None else None

    def _note_bypass(self) -> None:
        """A candidate the cache cannot host (scalar fallback — no device
        row to memoize). Counted only while a store is attached."""
        if self._store is not None:
            self._stats.n_cache_bypass += 1
            self._store.note_bypass()

    def flush(self) -> None:
        """Drain the dispatch pipeline: block until every outstanding batch
        has been scored (e.g. batches a finished session never consumed)."""
        for batch in self._inflight:
            if not batch.consumed:
                batch.wait()
                batch.consumed = True
        self._inflight.clear()

    def chain_runner(self):
        """The lazily-built :class:`~repro_torch.core.device_explore.
        DeviceChainRunner` this backend prices chain blocks with. Shares the
        workload encoding and the device; owns its own block cache and
        compile/fallback counters."""
        if self._chains is None:
            from .device_explore import DeviceChainRunner

            self._chains = DeviceChainRunner(self.tdg, self.db, self._enc, device=self.device)
        return self._chains

    def run_chains(self, req):
        """Price one fused (R, K) exploration block
        (:class:`~repro_torch.core.device_explore.ChainRequest` in,
        :class:`~repro_torch.core.device_explore.ChainBlockResult` out) — the
        device-resident counterpart of ``evaluate_candidates``: one dispatch
        runs K accept/reject iterations for R chains. Counted in the backend
        stats as R·K simulated designs in one dispatch."""
        runner = self.chain_runner()
        t0 = time.perf_counter()
        res = runner.run_chains(
            req.design, req.budget, r=req.r, k=req.k, seed=req.seed,
            it0=req.it0, menu=req.menu, alpha=req.alpha,
            temperature0=req.temperature0, temp_decay=req.temp_decay,
            taboo_ttl=req.taboo_ttl, carry=req.carry, alloc=req.alloc,
            cap_pe=req.cap_pe, cap_mem=req.cap_mem,
        )
        self._stats.n_sims += req.r * req.k
        self._stats.n_batched += req.r * req.k
        self._stats.n_dispatches += 1
        self._stats.wall_s += time.perf_counter() - t0
        return res

    def adopt_encoding(self, handle: SimHandle) -> None:
        """Promote ``handle``'s row encoding to be its base design's cached
        encoding for future dispatches. The explorer calls this right after
        accepting a move (`Candidate.accept` has just mutated the base to
        exactly the state the row's delta-encoding describes —
        ``apply_delta`` is bit-identical to a from-scratch encode), so the
        per-dispatch ``EncodedDesign.of`` walk disappears from the steady
        state.

        A winner priced through the Python FALLBACK has no row encoding —
        accepting it still mutates the base, so the call must *invalidate*
        any previously adopted encoding for that design instead of silently
        keeping a stale one."""
        cand = getattr(handle, "_cand", None)
        if cand is None:
            return  # foreign handle: no candidate, nothing to (in)validate
        if not isinstance(handle, _TorchHandle) or handle._batch.eds is None:
            self._adopted.pop(id(cand.base), None)
            return
        if len(self._adopted) > 512:  # bound design refs kept alive
            self._adopted.clear()
        ed = handle._ed if handle._ed is not None else handle._batch.eds[handle._j]
        self._adopted[id(cand.base)] = (cand.base, ed)

    def _track_inflight(self, batch: _TorchBatch) -> None:
        # in-flight = dispatched, not yet consumed by the host. Abandoned
        # batches are never consumed; to bound the list WITHOUT voiding the
        # flush() drain guarantee, overflow first sheds batches whose
        # compute already finished and only then blocks on the oldest
        # stragglers.
        alive = [b for b in self._inflight if not b.consumed]
        if len(alive) > 7:
            still = [b for b in alive if not b.ready()]
            for b in still[:-7]:
                b.wait()
            alive = still[-7:]
        self._inflight = alive
        self._inflight.append(batch)
        self._stats.n_inflight_max = max(
            self._stats.n_inflight_max, len(self._inflight)
        )

    # ------------------------------------------------------------------
    def evaluate(self, designs: Sequence[Design]) -> List[SimResult]:
        """Eager compatibility path: price + decode everything."""
        handles = self.evaluate_candidates([Candidate.of_design(d) for d in designs])
        return [h.result() for h in handles]

    def evaluate_candidates(self, cands: Sequence[Candidate]) -> List[SimHandle]:
        t0 = time.perf_counter()
        results: List[Optional[SimHandle]] = [None] * len(cands)
        fast = [i for i, c in enumerate(cands) if c.vectorizable()]
        fast_set = set(fast)
        for i, c in enumerate(cands):
            if i not in fast_set:
                with c.materialized(self.tdg) as d:
                    res = simulate(d, self.tdg, self.db)
                results[i] = _ReadyHandle(res, _host_fitness(res, c), c, self.tdg)
                self._stats.n_fallback += 1
                self._note_bypass()
        if fast:
            self._evaluate_batch([cands[i] for i in fast], fast, results)
        self._stats.n_sims += len(cands)
        self._stats.n_dispatches += 1
        self._stats.wall_s += time.perf_counter() - t0
        return results  # type: ignore[return-value]

    def _evaluate_batch(
        self, batch: List[Candidate], idx: List[int], results: List[Optional[SimHandle]]
    ) -> None:
        from ..kernels.phase_sim.kernel import out_layout
        from ..kernels.phase_sim.ops import phase_sim_rows
        from .phase_sim_torch import (
            ENCODED_FIELDS, EncodedDesign, UnsupportedDesignError, apply_delta,
            fill_budget, fill_row, fill_row_fields,
        )

        tE = time.perf_counter()
        # incremental encoding: each distinct base design is encoded once per
        # dispatch (candidates of one explorer iteration share their base),
        # then every candidate is the base row plus its recorded move delta.
        # apply_delta is copy-on-write, so `ed.f is base.f` marks untouched
        # fields — the buffer fill below broadcasts the base row per group
        # and rewrites only what each move changed.
        base_encs: Dict[int, EncodedDesign] = {}
        eds: List[EncodedDesign] = []
        keep: List[int] = []
        # content-addressed cache bookkeeping (store attached): per-row cache
        # keys to register after dispatch, same-dispatch alias rows, and the
        # batch-local key → row map that dedupes identical candidates two
        # co-batched sessions submit in one scheduler tick
        store = self._store
        row_keys: List[bytes] = []
        aliases: List[tuple] = []  # (results index, dispatched row, Candidate, ed)
        batch_rows: Dict[bytes, int] = {}
        bud_digests: Dict[tuple, bytes] = {}
        for pos, c in enumerate(batch):
            key = id(c.base)
            try:
                ed = base_encs.get(key)
                if ed is None:
                    # adopted encodings first: the explorer promotes the
                    # accepted winner's delta-encoding, so steady-state
                    # dispatches never re-walk the base's object graph
                    adopted = self._adopted.get(key)
                    if adopted is not None and adopted[0] is c.base:
                        ed = adopted[1]
                    else:
                        ed = EncodedDesign.of(c.base, self.tdg, self.db, self._enc)
                    base_encs[key] = ed
                if c.spec is not None:
                    ed = apply_delta(ed, c.delta, c.base, self.tdg, self.db, self._enc)
            except UnsupportedDesignError:
                # the typed capability check: shapes the encoding cannot
                # host route to the exact scalar path, mid-batch
                with c.materialized(self.tdg) as d:
                    res = simulate(d, self.tdg, self.db)
                results[idx[pos]] = _ReadyHandle(
                    res, _host_fitness(res, c), c, self.tdg
                )
                self._stats.n_fallback += 1
                self._note_bypass()
                continue
            if store is not None:
                bkey = (id(c.budget), c.alpha)
                bud_dig = bud_digests.get(bkey)
                if bud_dig is None:
                    bud_dig = bud_digests[bkey] = store.budget_digest(
                        c.budget, c.alpha
                    )
                ckey = store.key_of(ed, self._wl_digest, bud_dig)
                row = store.lookup(ckey)
                if row is not None:
                    # store hit: serve from the memoized row of an earlier
                    # identical evaluation — no device row dispatched. The
                    # consumer's own encoding rides along for adoption.
                    results[idx[pos]] = _TorchHandle(
                        _CachedBatch(row, self._stats, ed), 0, c, self
                    )
                    self._stats.n_cache_hits += 1
                    continue
                dup = batch_rows.get(ckey)
                if dup is not None:
                    # same-dispatch alias: an identical candidate is already
                    # in this batch — share its row instead of paying one
                    aliases.append((idx[pos], dup, c, ed))
                    self._stats.n_cache_hits += 1
                    store.note_alias_hit()
                    continue
                batch_rows[ckey] = len(eds)
                row_keys.append(ckey)
            keep.append(pos)
            eds.append(ed)
        n_cand = len(batch)
        if len(keep) != n_cand:
            batch = [batch[p] for p in keep]
            idx = [idx[p] for p in keep]
            if not batch:
                return

        # pad slots and batch to power-of-two buckets, so the buffers see a
        # handful of shapes over a whole exploration. Slot counts are
        # bounded by the task count, so the shared PE/MEM slot bucket is
        # pinned at pow2(T); the NoC-chain axis buckets to pow2 WITHOUT a
        # floor (the single-NoC regime stays at N = 1). The bucket spans the
        # candidate encodings AND their bases: the group fill broadcasts each
        # base row before applying diffs, so a batch of all-join candidates
        # must still host the base's shape.
        all_encs = list(base_encs.values())
        all_encs.extend(eds)
        need = max(max(e.pe_peak.shape[0], e.mem_bw.shape[0]) for e in all_encs)
        b = len(batch)
        key = _buffer_key(b, max(need, len(self._enc.names)),
                          max(e.noc_bw.shape[0] for e in all_encs))
        b_pad, slots, n_noc = key
        pair = self._buffers.get(key)
        if pair is None:
            pair = self._buffers[key] = [None, None]
        sel = self._bufsel.get(key, 0)
        self._bufsel[key] = 1 - sel
        buf = pair[sel]
        if buf is None:
            buf = pair[sel] = _RowBuffer(
                b_pad, len(self._enc.names), slots, len(self._enc.wl_names),
                n_noc, self.device,
            )
        # reuse guard: the host side of this buffer may still be the source
        # of the non-blocking H2D copy of an earlier dispatch — wait for the
        # event recorded behind THAT copy before scribbling over it
        buf.wait_reusable()
        rows = buf.rows

        # steady-state fast path (the explorer regime: one adopted base, one
        # budget, full bucket): the buffer already holds base-row content
        # everywhere except the cells last dispatch's diffs touched — restore
        # just those from the base instead of refilling every row
        bufkey = (key, sel)
        prev = self._buf_state.get(bufkey)
        c0 = batch[0]
        uniform = all(
            c.budget is c0.budget and c.alpha == c0.alpha for c in batch[1:]
        )
        # (a batch the cache or the fallback thinned is refilled in full: the
        # restore-only state is tracked for whole batches alone)
        state0 = len(base_encs) == 1 and b == b_pad == n_cand and uniform
        fast = (
            state0 and prev is not None
            and prev[0] is base_encs[id(c0.base)]
            and prev[1] is c0.budget
            and prev[2] == c0.alpha
        )
        dirty: List[tuple] = []
        if fast:
            base_ed = prev[0]
            for k, f in prev[3]:
                fill_row_fields(rows, k, base_ed, (f,))
            for k in range(b):
                ed = eds[k]
                if ed is not base_ed:
                    changed = [
                        f for f in ENCODED_FIELDS
                        if getattr(ed, f) is not getattr(base_ed, f)
                    ]
                    fill_row_fields(rows, k, ed, changed)
                    dirty.extend((k, f) for f in changed)
            self._buf_state[bufkey] = (base_ed, c0.budget, c0.alpha, dirty)
        else:
            # fill per base-group: write the base encoding + budget once,
            # broadcast across the group's rows, then apply per-candidate diffs
            j = 0
            while j < b:
                cg = batch[j]
                base_ed = base_encs[id(cg.base)]
                end = j + 1
                while end < b and batch[end].base is cg.base:
                    end += 1
                fill_row(rows, j, base_ed)
                bud = cg.budget
                if bud is not None:
                    fill_budget(rows, j, self._enc, bud.latency_s, bud.power_w,
                                bud.area_mm2, cg.alpha)
                else:  # neutral scoring row (buffers are reused across dispatches)
                    fill_budget(rows, j, self._enc, {}, 1e30, 1e30, 0.0)
                if end - j > 1:
                    for arr in rows.values():
                        arr[j + 1:end] = arr[j]
                for k in range(j, end):
                    ed, c = eds[k], batch[k]
                    if ed is not base_ed:
                        changed = [
                            f for f in ENCODED_FIELDS
                            if getattr(ed, f) is not getattr(base_ed, f)
                        ]
                        fill_row_fields(rows, k, ed, changed)
                        dirty.extend((k, f) for f in changed)
                    if k > j and c.budget is not bud:
                        if c.budget is not None:
                            fill_budget(rows, k, self._enc, c.budget.latency_s,
                                        c.budget.power_w, c.budget.area_mm2, c.alpha)
                        else:
                            fill_budget(rows, k, self._enc, {}, 1e30, 1e30, 0.0)
                j = end
            if b < b_pad:  # pad the batch axis with copies of row 0
                for arr in rows.values():
                    arr[b:b_pad] = arr[0]
            # the invariant the fast path needs: every row holds base+budget
            # content except `dirty` — only true for single-group, uniform-
            # budget, full-bucket dispatches
            if state0:
                self._buf_state[bufkey] = (
                    base_encs[id(c0.base)], c0.budget, c0.alpha, dirty
                )
            else:
                self._buf_state.pop(bufkey, None)
        if key not in self._shapes:
            self._shapes.add(key)
            self._stats.n_compiles += 1
        self._stats.encode_s += time.perf_counter() - tE

        tD = time.perf_counter()
        t = len(self._enc.names)
        lay = out_layout(t, slots, slots, n_noc, len(self._enc.wl_names))
        buf.upload()
        if self.device.type == "cuda":
            dev_out = torch.empty((b_pad, lay["width"]), dtype=torch.float32,
                                  device=self.device)
            phase_sim_rows(self._enc, buf.dev, nocs=buf.nocs, out=dev_out)
            out = torch.empty((b_pad, lay["width"]), dtype=torch.float32,
                              pin_memory=True)
            out.copy_(dev_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out, done = phase_sim_rows(self._enc, buf.dev), None
        self._stats.dispatch_s += time.perf_counter() - tD
        shared = _TorchBatch(out, done, self._stats, eds, lay, t)
        self._track_inflight(shared)
        for j, i in enumerate(idx):
            results[i] = _TorchHandle(shared, j, batch[j], self)
            self._stats.n_batched += 1
        if store is not None:
            # register every dispatched row for future sessions (lazy: the
            # entry holds (batch, row) until a hit materializes it) and wire
            # same-dispatch aliases onto the rows they dedupe against
            for j, ckey in enumerate(row_keys):
                store.insert(ckey, shared, j)
                self._stats.n_cache_misses += 1
            for i, j, c, ed in aliases:
                results[i] = _TorchHandle(shared, j, c, self, ed)

    # ------------------------------------------------------------------
    # host-exact scalar rollups, shared between the lazy ``_decode`` and the
    # policy-layer ``SimTelemetry`` so both produce bit-identical floats
    def _task_energy_pj(self, design: Design) -> Dict[str, float]:
        """Per-task dynamic energy: rate-independent (every task drains its
        full (ops, read, write) totals); the NoC term scales with the task's
        route hop count on multi-NoC chains."""
        blocks, d_pe, d_mem = design.blocks, design.task_pe, design.task_mem
        pe_pj, mem_pj, noc_pj = self._pe_pj, self._mem_pj, self._noc_pj
        if len(design.noc_chain) == 1:  # hops == 1 everywhere: skip routing
            return {
                n: pe_pj[blocks[d_pe[n]].subtype] * self._ops[k]
                + (mem_pj[blocks[d_mem[n]].subtype] + noc_pj) * self._rw[k]
                for k, n in enumerate(self._enc.names)
            }
        pos = {m: i for i, m in enumerate(design.noc_chain)}
        att = design.attached_noc
        return {
            n: pe_pj[blocks[d_pe[n]].subtype] * self._ops[k]
            + (
                mem_pj[blocks[d_mem[n]].subtype]
                + noc_pj * (abs(pos[att[d_pe[n]]] - pos[att[d_mem[n]]]) + 1)
            ) * self._rw[k]
            for k, n in enumerate(self._enc.names)
        }

    def _mem_caps(self, design: Design) -> Dict[str, float]:
        cap: Dict[str, float] = {m: 0.0 for m in design.mems()}
        d_mem = design.task_mem
        for k, n in enumerate(self._enc.names):
            cap[d_mem[n]] += self._wbytes[k]
        return cap

    def _area_mm2(self, design: Design, cap: Dict[str, float]) -> float:
        db = self.db
        area = 0.0
        for bname, blk in design.blocks.items():
            if blk.kind == BlockKind.MEM and blk.subtype == "sram":
                area += db.area.sram_mm2_per_mb * max(cap[bname], 1.0) / 1e6
            else:
                area += db.block_area_mm2(blk)
        return area

    def _wl_latency(self, fin: List[float]) -> Dict[str, float]:
        wl_latency: Dict[str, float] = {}
        for w, f in zip(self._wl_of, fin):
            if f > wl_latency.get(w, 0.0):
                wl_latency[w] = f
        return wl_latency

    def _decode(
        self,
        design: Design,
        latency: float,
        finish: np.ndarray,
        bneck: np.ndarray,
        kind_s: np.ndarray,
        pe_busy: np.ndarray,
        mem_busy: np.ndarray,
        noc_busy: np.ndarray,
        alp_time: float,
        traffic: float,
        n_phases: int,
    ) -> SimResult:
        db = self.db
        names = self._enc.names
        blocks, d_pe, d_mem = design.blocks, design.task_pe, design.task_mem
        chain = design.noc_chain
        fin = finish.tolist()
        codes = bneck.tolist()
        finish_s = dict(zip(names, fin))
        # codes are packed: 0/1 = pe/mem, 2 + 3·k = NoC at chain index k
        task_bneck = {n: _BNECK_KINDS[min(c, 2)] for n, c in zip(names, codes)}
        task_bneck_block = {
            n: d_pe[n] if c == 0 else (
                d_mem[n] if c == 1 else chain[(c - 2) // 3]
            )
            for n, c in zip(names, codes)
        }
        task_energy_pj = self._task_energy_pj(design)
        energy_j = sum(task_energy_pj.values()) * 1e-12 + total_leakage_w(
            design, db
        ) * latency
        wl_latency = self._wl_latency(fin)
        # fused mem-capacity + area rollup (ppa.mem_capacities/total_area_mm2
        # recomputed here with the precomputed write-bytes table)
        cap = self._mem_caps(design)
        area = self._area_mm2(design, cap)
        # per-block bottleneck seconds: device telemetry columns resolved to
        # block names via the encoding slot order (= block insertion order;
        # NoC columns are in chain order)
        block_bneck_s: Dict[str, float] = {}
        ipe = imem = 0
        for bname, blk in blocks.items():
            if blk.kind == BlockKind.PE:
                block_bneck_s[bname] = float(pe_busy[ipe])
                ipe += 1
            elif blk.kind == BlockKind.MEM:
                block_bneck_s[bname] = float(mem_busy[imem])
                imem += 1
        for i, bname in enumerate(chain):
            block_bneck_s[bname] = float(noc_busy[i])
        return SimResult(
            latency_s=latency,
            workload_latency_s=wl_latency,
            energy_j=energy_j,
            power_w=energy_j / latency if latency > 0 else 0.0,
            area_mm2=area,
            n_phases=n_phases,
            bottleneck_s={k: float(kind_s[i]) for i, k in enumerate(_BNECK_KINDS)},
            task_bottleneck=task_bneck,
            task_finish_s=finish_s,
            mem_capacity_bytes=cap,
            task_bottleneck_block=task_bneck_block,
            task_energy_j={n: e * 1e-12 for n, e in task_energy_pj.items()},
            block_bottleneck_s=block_bneck_s,
            avg_accel_parallelism=alp_time / latency if latency > 0 else 1.0,
            total_traffic_bytes=traffic,
        )

BACKENDS = {
    "python": PythonBackend,
    "torch": TorchBatchedBackend,
}


def make_backend(name: str, tdg: TaskGraph, db: HardwareDatabase,
                 device=None) -> SimulatorBackend:
    """Instantiate a registered backend by name (`ExplorerConfig.backend`).
    ``device`` reaches the batched backend (``None`` = the card); the scalar
    Python backend has no device."""
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; known: {sorted(BACKENDS)}") from None
    if cls is PythonBackend:
        return cls(tdg, db)
    return cls(tdg, db, device=device)
