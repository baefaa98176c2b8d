"""Launch audit: run the port's hot entry points and check what they
dispatched — the port's counterpart of the reference's jaxpr audit.

Where ``lint.py`` reads source, this pass runs the code. Eager torch has no
program to walk, so each entry point runs once, on the device asked for,
under :class:`OpLog` (a ``TorchDispatchMode`` that sees every aten op the
call dispatches), and the audit checks:

  * **no forbidden ops** (any device) — ``_local_scalar_dense`` (the op
    behind ``.item()`` and ``bool(tensor)``), the data-sized ops
    (``nonzero``, ``unique*``, ``masked_select``, ``bincount``), and a
    ``_to_copy``/``copy_`` whose target device differs from its input's.
    Dtype casts stay legal (a chain block makes about 1,350 of them);
  * **the kernel really launched** (CUDA only) — one ``ops.phase_sim``
    call moves ``phase_sim_cuda.launches`` by exactly 1, and the kernel's
    symbol shows among the CUDA kernels of a ``torch.profiler`` trace. The
    ctypes launch bypasses the dispatcher, so the op log cannot see it: a
    quiet fallback to the plain version must fail here;
  * **the chain block** (CUDA only, besides the op log) — exactly K
    launches; its K iterations run under
    ``torch.cuda.set_sync_debug_mode("error")``; no ``Memcpy DtoH`` and no
    ``cudaStreamSynchronize``/``cudaDeviceSynchronize`` inside the profiled
    block window. On the CPU ``set_sync_debug_mode`` does nothing, and the
    op log is the only runtime check;
  * **the buffer-key bound** — the backend buckets batch and slot shapes to
    pow2 (floor 4) so the row-buffer set stays small. The audit enumerates
    the documented production grid (batch and slots up to 64, NoC counts
    up to 8) through the real ``_bucket`` and ``_buffer_key`` and fails if
    either yields more than :data:`BUCKET_GRID_BOUND` distinct keys.

Entry points: ``phase_sim_torch.phase_sim_plain`` (the plain pricing core,
the counterpart of ``simulate_batch``), one chain block
(``DeviceChainRunner.run_chains``, farsi menu, alloc table, R = 4, K = 8),
and the kernel wrapper ``ops.phase_sim``.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

__all__ = [
    "BUCKET_GRID_BOUND",
    "CHAIN_R",
    "CHAIN_K",
    "KERNEL_SYMBOL",
    "OpLog",
    "forbidden_op",
    "audit_ops",
    "audit_phase_sim_plain",
    "audit_chain_block",
    "audit_kernel_wrapper",
    "audit_bucket_grid",
    "run_launch_audit",
]

# distinct (batch-bucket, slot-bucket, noc) keys allowed for the standard
# production grid: batch 1..64, slots 1..64, noc ∈ {1, 2, 4, 8}. _bucket's
# pow2-floor-4 gives 5 batch × 5 slot × 4 noc = 100 exactly; the bound
# leaves zero headroom on purpose — widening the bucket set is a deliberate
# decision that must touch docs/ANALYSIS_TORCH.md too.
BUCKET_GRID_BOUND = 100

CHAIN_R, CHAIN_K = 4, 8  # the audited chain block
KERNEL_SYMBOL = "phase_sim_kernel"  # the CUDA kernel's name in a profiler trace

F_PLAIN = "src/repro_torch/core/phase_sim_torch.py"
F_DEVEXP = "src/repro_torch/core/device_explore.py"
F_OPS = "src/repro_torch/kernels/phase_sim/ops.py"
F_KERNEL = "src/repro_torch/kernels/phase_sim/kernel.py"
F_BACKEND = "src/repro_torch/core/backend.py"
F_DOC = "docs/ANALYSIS_TORCH.md"

_DATA_SIZED = ("nonzero", "masked_select", "bincount")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _device_of(x) -> Optional[torch.device]:
    return x.device if isinstance(x, torch.Tensor) else None


def forbidden_op(name: str, args: tuple, kwargs: dict) -> Optional[str]:
    """Why an aten op (its schema's base name) must not run in a hot path,
    or None where it may."""
    if name == "_local_scalar_dense":
        return "_local_scalar_dense (.item() / bool(tensor))"
    if name in _DATA_SIZED or "unique" in name:
        return name
    if name == "_to_copy" and kwargs.get("device") is not None:
        src = _device_of(args[0]) if args else None
        dst = torch.device(kwargs["device"])
        if src is not None and src != dst:
            return f"_to_copy {src.type}->{dst.type}"
    if name == "copy_" and len(args) >= 2:
        dst, src = _device_of(args[0]), _device_of(args[1])
        if dst is not None and src is not None and dst != src:
            return f"copy_ {src.type}->{dst.type}"
    return None


class OpLog(TorchDispatchMode):
    """Counts every aten op dispatched inside it (``counts``, by schema base
    name) and the forbidden ones (``bad``, by :func:`forbidden_op`'s
    reason)."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self.bad: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        self.counts[name] += 1
        why = forbidden_op(name, args, kwargs)
        if why is not None:
            self.bad[why] += 1
        return func(*args, **kwargs)


def audit_ops(name: str, log: OpLog, path: str) -> List[Finding]:
    """Findings for the forbidden ops one entry point dispatched."""
    return [
        Finding(
            pass_name="launch", rule="forbidden-op",
            message=f"`{name}` dispatched {why} ×{n} — a host round trip "
            "inside the hot path",
            path=path,
        )
        for why, n in sorted(log.bad.items())
    ]


def _fixture(device: str):
    """The reference audit's fixture: the audio workload on a random
    single-NoC design (seed 7), the calibrated budget."""
    from ..core import (
        DeviceChainRunner, HardwareDatabase, audio, calibrated_budget,
        random_single_noc_designs,
    )
    from ..core.phase_sim_torch import EncodedDesign

    db = HardwareDatabase()
    g = audio()
    bud = calibrated_budget(db)
    d = random_single_noc_designs(g, 1, seed=7)[0]
    runner = DeviceChainRunner(g, db, device=device)
    ed = EncodedDesign.of(d, g, db, runner.enc)
    return runner, d, ed, bud


def _rows(runner, ed, bud, b: int, device: str) -> Dict[str, torch.Tensor]:
    """A (b,)-batched rows dict shaped like a production dispatch, on
    ``device``."""
    from ..core.phase_sim_torch import alloc_rows, fill_budget, fill_row, rows_to

    enc = runner.enc
    rows = alloc_rows(
        b, len(enc.names), int(ed.pe_peak.shape[0]), int(ed.mem_bw.shape[0]),
        len(enc.wl_names), int(ed.noc_bw.shape[0]),
    )
    for j in range(b):
        fill_row(rows, j, ed)
        fill_budget(rows, j, enc, bud.latency_s, bud.power_w, bud.area_mm2, 0.05)
    return rows_to(rows, device)


def _profile(fn) -> "torch.profiler.profile":
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _cuda_kernels(prof) -> List:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def audit_phase_sim_plain(runner, ed, bud, device: str,
                          report: Optional[dict] = None) -> List[Finding]:
    """``phase_sim_plain`` on a B = 4 batch under the op log."""
    from ..core.phase_sim_torch import phase_sim_plain

    rows = _rows(runner, ed, bud, 4, device)
    w = runner.enc.on(device)  # the workload's tensors exist before the call
    log = OpLog()
    with log:
        phase_sim_plain(w, rows, len(runner.enc.names))
    if report is not None:
        report["phase_sim_plain"] = {"ops": sum(log.counts.values()),
                                     "forbidden": sum(log.bad.values())}
    return audit_ops("phase_sim_plain", log, F_PLAIN)


def audit_kernel_wrapper(runner, ed, bud, device: str,
                         report: Optional[dict] = None) -> List[Finding]:
    """``ops.phase_sim`` under the op log; on the card also one launch
    exactly and the kernel's symbol in a profiler trace."""
    from ..kernels.phase_sim import kernel, ops

    rows = _rows(runner, ed, bud, 4, device)
    ops.phase_sim(runner.enc, rows)  # warm: the build, the workload on the device
    log = OpLog()
    launches0 = kernel.phase_sim_cuda.launches
    with log:
        ops.phase_sim(runner.enc, rows)
    launches = kernel.phase_sim_cuda.launches - launches0
    out = audit_ops("ops.phase_sim", log, F_OPS)
    entry = {"ops": sum(log.counts.values()), "forbidden": sum(log.bad.values())}
    if device == "cuda":
        prof = _profile(lambda: ops.phase_sim(runner.enc, rows))
        hits = [e for e in _cuda_kernels(prof) if KERNEL_SYMBOL in e.name]
        entry.update(launches=launches, kernel_events=len(hits))
        if launches != 1:
            out.append(Finding(
                pass_name="launch", rule="required-kernel",
                message=f"one ops.phase_sim call moved phase_sim_cuda.launches "
                f"by {launches}, not 1 — the wrapper no longer launches the "
                "CUDA kernel (a quiet fallback to the plain version?)",
                path=F_OPS, related=(F_KERNEL,),
            ))
        if not hits:
            out.append(Finding(
                pass_name="launch", rule="required-kernel",
                message=f"no `{KERNEL_SYMBOL}` among the CUDA kernels of a "
                "profiled ops.phase_sim call",
                path=F_OPS, related=(F_KERNEL,),
            ))
    if report is not None:
        report["ops.phase_sim"] = entry
    return out


def audit_chain_block(runner, d, bud, device: str, r: int = CHAIN_R, k: int = CHAIN_K,
                      report: Optional[dict] = None) -> List[Finding]:
    """One (R, K) chain block, farsi menu, alloc table: its K iterations
    under the op log (and, on the card, sync-debug "error"); on the card
    also K launches exactly and a profiled block window free of
    device-to-host copies and synchronisations."""
    from ..kernels.phase_sim import kernel

    kw = dict(r=r, k=k, menu="farsi", alloc=True, seed=0)
    runner.run_chains(d, bud, **kw)  # warm: the block, the workload on the device
    log = OpLog()
    cuda = device == "cuda"

    @contextlib.contextmanager
    def guarded():
        with log:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)

    out: List[Finding] = []
    name = f"DeviceChainRunner block (R={r}, K={k}, farsi, alloc)"
    old_guard = runner.loop_guard
    runner.loop_guard = guarded
    launches0 = kernel.phase_sim_cuda.launches
    try:
        runner.run_chains(d, bud, **kw)
    except RuntimeError as e:
        if not (cuda and "synchronizing" in str(e)):  # sync-debug's error
            raise
        out.append(Finding(
            pass_name="launch", rule="sync-debug",
            message=f"`{name}` synchronised with the host inside its K "
            f"iterations: {e}",
            path=F_DEVEXP,
        ))
    finally:
        runner.loop_guard = old_guard
    launches = kernel.phase_sim_cuda.launches - launches0
    out.extend(audit_ops(name, log, F_DEVEXP))
    entry = {"r": r, "k": k, "ops": sum(log.counts.values()),
             "forbidden": sum(log.bad.values()), "casts": log.counts["_to_copy"]}
    if cuda:
        entry["launches"] = launches
        if launches != k:
            out.append(Finding(
                pass_name="launch", rule="required-kernel",
                message=f"`{name}` made {launches} phase-sim launches, not "
                f"K = {k} — an iteration no longer prices through the kernel",
                path=F_DEVEXP, related=(F_OPS, F_KERNEL),
            ))
        entry.update(_window_audit(runner, d, bud, kw, name, out))
    if report is not None:
        report["chain_block"] = entry
    return out


WINDOW = "repro_torch.analysis::chain_block_window"


def _window_audit(runner, d, bud, kw, name: str, out: List[Finding]) -> dict:
    """Profile one more block with its K iterations marked as a window;
    flag device-to-host copies and synchronisations inside the window, and
    count the kernel's launches in the trace."""
    from torch.autograd import DeviceType

    old_guard = runner.loop_guard
    runner.loop_guard = lambda: torch.profiler.record_function(WINDOW)
    try:
        prof = _profile(lambda: runner.run_chains(d, bud, **kw))
    finally:
        runner.loop_guard = old_guard
    events = prof.events()
    windows = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if len(windows) != 1:
        out.append(Finding(
            pass_name="launch", rule="window",
            message=f"the profiled `{name}` shows {len(windows)} block windows, "
            "not 1 — the trace cannot be read",
            path=F_DEVEXP,
        ))
        return {"window_events": len(windows)}
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    inside = [e for e in events if w0 <= e.time_range.start <= w1]
    runtime = [e.name for e in inside
               if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    syncs = [n for n in runtime if n in _SYNC_CALLS]
    dtoh = [e.name for e in inside
            if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy DtoH")]
    kernels = [e for e in _cuda_kernels(prof) if KERNEL_SYMBOL in e.name]
    if not runtime:
        out.append(Finding(
            pass_name="launch", rule="window",
            message=f"the profiled `{name}` shows no CUDA runtime call inside "
            "its block window: the trace cannot show a synchronisation",
            path=F_DEVEXP,
        ))
    for what, hits in (("synchronisation", syncs), ("device-to-host copy", dtoh)):
        if hits:
            out.append(Finding(
                pass_name="launch", rule="window",
                message=f"`{name}`: {len(hits)} {what} event(s) inside the "
                f"block window ({sorted(set(hits))})",
                path=F_DEVEXP,
            ))
    if len(kernels) != kw["k"]:
        out.append(Finding(
            pass_name="launch", rule="required-kernel",
            message=f"`{name}`: {len(kernels)} `{KERNEL_SYMBOL}` kernels in the "
            f"profiled block, not K = {kw['k']}",
            path=F_DEVEXP, related=(F_OPS, F_KERNEL),
        ))
    return {"window_ms": (w1 - w0) / 1e3, "window_runtime_calls": len(runtime),
            "window_syncs": len(syncs),
            "window_dtoh": len(dtoh), "kernel_events": len(kernels)}


def audit_bucket_grid(report: Optional[dict] = None) -> List[Finding]:
    """The production grid through the real ``_bucket`` (the reference's
    key) and ``_buffer_key`` (the row-buffer key ``n_compiles`` counts)."""
    from ..core.backend import _bucket, _buffer_key

    grid = [(b, s, n) for b in range(1, 65) for s in range(1, 65) for n in (1, 2, 4, 8)]
    counts = {
        "bucket": len({(_bucket(b), _bucket(s), n) for b, s, n in grid}),
        "buffer_key": len({_buffer_key(b, s, n) for b, s, n in grid}),
    }
    if report is not None:
        report["bucket_grid"] = {**counts, "bound": BUCKET_GRID_BOUND}
    return [
        Finding(
            pass_name="launch", rule="buffer-key-bound",
            message=f"the standard bucket grid yields {n} distinct {what} "
            f"keys (> documented bound {BUCKET_GRID_BOUND}) — every extra key "
            "is another set of row buffers at serve time; see "
            "docs/ANALYSIS_TORCH.md before widening `_bucket`",
            path=F_BACKEND, related=(F_DOC,),
        )
        for what, n in counts.items() if n > BUCKET_GRID_BOUND
    ]


def _entry(name: str, path: str, fn) -> List[Finding]:
    """``fn()``'s findings; an entry point that raises is itself a finding
    (the code under audit is broken), not a crash of the pass."""
    try:
        return fn()
    except Exception as e:
        return [Finding(
            pass_name="launch", rule="entry-failed",
            message=f"{name} raised {type(e).__name__}: {e}", path=path,
        )]


def run_launch_audit(
    device: str = "cuda",
    entries: Optional[List[str]] = None,
    report: Optional[dict] = None,
) -> List[Finding]:
    """Run and audit all entry points on ``device`` (or a named subset of
    ``{"plain", "chain_block", "wrapper", "buckets"}``); ``report``, where
    given, collects each entry's numbers."""
    want = set(entries) if entries is not None else None

    def on(name: str) -> bool:
        return want is None or name in want

    out: List[Finding] = []
    if on("buckets"):
        out.extend(_entry("the bucket grid", F_BACKEND, lambda: audit_bucket_grid(report)))
    if not (on("plain") or on("chain_block") or on("wrapper")):
        return out
    fixture = []
    out.extend(_entry("the audit fixture", F_DEVEXP,
                      lambda: fixture.append(_fixture(device)) or []))
    if not fixture:
        return out
    runner, d, ed, bud = fixture[0]
    if on("plain"):
        out.extend(_entry("phase_sim_plain", F_PLAIN,
                          lambda: audit_phase_sim_plain(runner, ed, bud, device, report)))
    if on("chain_block"):
        out.extend(_entry("the chain block", F_DEVEXP,
                          lambda: audit_chain_block(runner, d, bud, device, report=report)))
    if on("wrapper"):
        out.extend(_entry("ops.phase_sim", F_OPS,
                          lambda: audit_kernel_wrapper(runner, ed, bud, device, report)))
    return out
