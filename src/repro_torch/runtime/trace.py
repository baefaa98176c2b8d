"""Spans and counters at the layer boundaries of the port's model path.

``span(name)`` marks a phase (``train/step``, ``train/forward``,
``moe/dispatch``, ...); ``count(name, value)`` adds to a counter. Both are
live only inside :func:`recording`:

  * **off** (no recording open; the default): ``span`` returns one shared
    no-op context manager. It launches nothing, allocates nothing and never
    synchronises; ``count`` does nothing, and its call sites compute no
    value (they test :func:`counting` first);
  * **inside a recording**: a span appends a record, its name, parent (the
    innermost open span), root (the outermost open span: one train step or
    one request), host start and end from ``time.perf_counter_ns()`` and,
    where CUDA is initialised, a pair of timing events on the current
    stream (none while the stream is capturing a graph). Counters take
    Python numbers or 0-d device tensors; the device ones are summed on
    the device and read once, when the recording ends.

A span opens no profiler range: a ``record_function`` range around kernel
launches casts a device-side shadow (a GPU user annotation from its first
kernel to its last), and a trace reader that takes the union of device
events as busy time would count that shadow, gaps and all, as work.

The open spans form one process-wide stack: the autograd engine's thread
runs while the caller waits inside ``train/backward``, so a span it opens
(a recomputed MoE layer) nests there.

    with trace.recording() as r:
        state, metrics = train_step(state, batch)
    r.summary()["spans"]["train/backward"]["host_ms"]

A span's self time is its interval less the union of its children's, on
the host's clock and on the device's (the events' times). Device times
bracket the work the device ran between the span's two events: where the
host enqueues slower than the device computes, they include the device's
idle gaps.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import torch

_OFF = contextlib.nullcontext()
_ACTIVE: Optional["Recording"] = None


def span(name: str):
    """A context manager marking the phase ``name`` (module docstring); off,
    the one shared no-op."""
    if _ACTIVE is None:
        return _OFF
    return _Span(name)


def counting() -> bool:
    """Whether a recording is open: a call site computes a counter's value
    only then."""
    return _ACTIVE is not None


def count(name: str, value) -> None:
    """Add ``value`` (a Python number or a 0-d tensor) to the counter
    ``name`` of the open recording; nothing outside one."""
    if _ACTIVE is not None:
        _ACTIVE._count(name, value)


@contextlib.contextmanager
def recording() -> Iterator["Recording"]:
    """Record every span and counter inside the block; on exit synchronise
    once and resolve the device times. One recording at a time."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._resolve()


class _Span:
    __slots__ = ("name", "_rec", "_i")

    def __init__(self, name: str):
        self.name = name
        self._rec = self._i = None

    def __enter__(self):
        self._rec = _ACTIVE
        self._i = self._rec._open(self.name)
        return self

    def __exit__(self, *exc):
        self._rec._close(self._i)
        return False


class Recording:
    """The spans and counters of one :func:`recording` block. Read
    :meth:`summary` after the block."""

    def __init__(self):
        self._cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        # [name, parent, root, host start ns, host end ns, start event, end event]
        self._records: List[list] = []
        self._stack: List[int] = []
        self._host: Dict[str, float] = {}
        self._device: Dict[str, torch.Tensor] = {}
        self._base = self._event()
        self.spans: List[dict] = []  # resolved records, in opening order
        self.counters: Dict[str, float] = {}

    def _event(self):
        if not self._cuda or torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _open(self, name: str) -> int:
        i = len(self._records)
        stack = self._stack
        self._records.append([name, stack[-1] if stack else None, stack[0] if stack else i,
                              time.perf_counter_ns(), None, self._event(), None])
        stack.append(i)
        return i

    def _close(self, i: int) -> None:
        r = self._records[i]
        if r[5] is not None:
            r[6] = self._event()
        r[4] = time.perf_counter_ns()
        self._stack.remove(i)

    def _count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            acc = self._device.get(name)
            self._device[name] = value.detach() if acc is None else acc + value.detach()
        else:
            self._host[name] = self._host.get(name, 0) + value

    def _resolve(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()
        t0 = self._records[0][3] if self._records else 0
        base = self._base
        for name, parent, root, h0, h1, e0, e1 in self._records:
            timed = base is not None and e0 is not None and e1 is not None
            self.spans.append({"name": name, "parent": parent, "root": root,
                               "host": ((h0 - t0) / 1e6, (h1 - t0) / 1e6),
                               "device": (base.elapsed_time(e0), base.elapsed_time(e1)) if timed else None})
        self.counters = dict(self._host)
        for name, acc in self._device.items():
            self.counters[name] = self.counters.get(name, 0) + acc.item()
        self._records, self._device, self._base = [], {}, None

    def summary(self) -> dict:
        """``spans``: for each span name, its count ``n``, ``host_ms`` and
        ``host_self_ms`` (totals), ``device_ms`` and ``device_self_ms``
        (None where a span of that name has no device events); ``roots``:
        for each root span in order, its ``name`` and the same figures over
        the spans under it (itself included); ``counters``."""
        kids: Dict[int, List[int]] = {}
        for i, s in enumerate(self.spans):
            if s["parent"] is not None:
                kids.setdefault(s["parent"], []).append(i)
        rows = []
        for i, s in enumerate(self.spans):
            row = {"name": s["name"], "root": s["root"]}
            for clock in ("host", "device"):
                iv = s[clock]
                inner = [self.spans[j][clock] for j in kids.get(i, ())]
                if iv is None or any(c is None for c in inner):
                    row[clock], row[clock + "_self"] = iv and iv[1] - iv[0], None
                else:
                    row[clock], row[clock + "_self"] = iv[1] - iv[0], iv[1] - iv[0] - _covered(inner, *iv)
            rows.append(row)
        by_root: Dict[int, List[dict]] = {}
        for r in rows:  # a root opens before the spans under it, so roots come in order
            by_root.setdefault(r["root"], []).append(r)
        roots = [{"name": self.spans[i]["name"], "spans": _by_name(rs)} for i, rs in by_root.items()]
        return {"spans": _by_name(rows), "roots": roots, "counters": dict(self.counters)}


def _covered(intervals, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _by_name(rows) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for r in rows:
        s = out.setdefault(r["name"], {"n": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                       "device_ms": 0.0, "device_self_ms": 0.0})
        s["n"] += 1
        for key in ("host", "host_self", "device", "device_self"):
            v = r[key]
            s[key + "_ms"] = None if v is None or s[key + "_ms"] is None else s[key + "_ms"] + v
    return out
