"""The program's own spans and counters (``repro_torch.runtime.trace``) in a
traced run, for the per-layer metrics that read them.

The first reader that asks collects the garbage, then runs short driver
windows of the cell's traffic inside one ``trace.recording()`` until at
least ``RECORD_SECONDS`` have passed and ``MIN_UNITS`` units have run (a
window runs one training step or a few requests), with the benchmark's
own spans off and no profiler on: the host times come without the
profiler's cost, from enough units that one slow one does not move their
median, and the program state is the window's. The summary is cached on the driver, so a run
records once whatever the number of readers. A program that has no
``runtime.trace`` module gives ``None`` and so does every reader; a program
that has it but records no span of a reader's name raises. A line on
standard error gives the recorded units' tokens a second beside the
measured window's (what recording costs) and the spread of each span's
time a unit.

A root is one unit of the driver's work: ``train/step`` a training step,
``serve/prefill`` a request.
"""
from __future__ import annotations

import gc
import importlib.util
import statistics
import sys
from typing import Optional

from perfbench.devtrace import Tracer

RECORD_SECONDS = 4
MIN_UNITS = 10
_ATTR = "program_spans"  # the driver's attribute holding the summary


def summary(run) -> Optional[dict]:
    """``trace.recording().summary()`` of one further driver window (the
    module docstring), or None."""
    if not hasattr(run.driver, _ATTR):
        setattr(run.driver, _ATTR, _record(run))
    return getattr(run.driver, _ATTR)


def _record(run) -> Optional[dict]:
    if importlib.util.find_spec("repro_torch.runtime.trace") is None:
        return None
    from repro_torch.runtime import trace

    gc.collect()
    units = tokens = seconds = 0
    with trace.recording() as rec:
        while units < MIN_UNITS or seconds < RECORD_SECONDS:
            window = run.driver.window(RECORD_SECONDS / MIN_UNITS, Tracer(False))
            units, tokens, seconds = units + window.attempted, tokens + window.tokens, seconds + window.seconds
    s = rec.summary()
    measured = run.window
    print(f"spans: recorded {units} units, {tokens / seconds:.1f} tokens/s;"
          f" measured window {measured.tokens / measured.seconds:.1f} tokens/s", file=sys.stderr)
    for name in sorted({n for r in s["roots"] for n in r["spans"]}):
        for field in ("host_ms", "device_ms"):
            values = [r["spans"][name][field] for r in s["roots"] if name in r["spans"]]
            if len(values) > 1 and None not in values:
                q1, q2, q3 = statistics.quantiles(values, n=4)
                print(f"spans: {name} {field} a unit: median {q2:.3f}, quartiles {q1:.3f} {q3:.3f},"
                      f" range {min(values):.3f} {max(values):.3f}", file=sys.stderr)
    return s


def per_root(run, root: str, name: str, field: str) -> Optional[float]:
    """The median over the recorded ``root`` spans of ``field``
    (``host_ms``, ``device_ms``, ...) summed over the spans ``name`` under
    each; None where the program has no spans or these carry no such
    figure (no device events off CUDA). Raises where a recorded ``root``
    lacks the span ``name``, or none was recorded."""
    s = summary(run)
    if s is None:
        return None
    units = [r["spans"] for r in s["roots"] if r["name"] == root]
    lacking = sum(name not in u for u in units)
    if not units or lacking:
        raise LookupError(f"{lacking} of {len(units)} recorded {root} spans hold no {name} span")
    values = [u[name][field] for u in units]
    if None in values:
        return None
    return statistics.median(values)
