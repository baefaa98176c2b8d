"""Straggler and failure detection, and recovery.

Detection is host-local and cheap: (1) a per-host heartbeat file (mtime-based
liveness for a launcher or supervisor), (2) an EMA step-time monitor that
flags outlier steps — the serve layer's scheduler records every tick in one
and counts the ticks it flags — and (3) a supervisor loop that turns a
failed training step into checkpoint-restore and retry.

The file-based transport lets the whole detection path run (and be tested)
in one process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StepStats:
    step: int
    duration_s: float
    is_straggler: bool
    ema_s: float


class StepTimeMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold×`` EMA."""

    def __init__(self, ema_decay: float = 0.9, threshold: float = 2.0, warmup: int = 3):
        self.ema_decay = ema_decay
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[StepStats] = []

    def record(self, step: int, duration_s: float) -> StepStats:
        self.n += 1
        if self.ema is None:
            self.ema = duration_s
        is_straggler = (
            self.n > self.warmup and duration_s > self.threshold * self.ema
        )
        if not is_straggler:  # don't poison the EMA with outliers
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * duration_s
        stats = StepStats(step, duration_s, is_straggler, self.ema)
        if is_straggler:
            self.flagged.append(stats)
        return stats


class Heartbeat:
    """File-mtime liveness: each host touches its file; anyone can audit."""

    def __init__(self, directory: str, host_id: int):
        self.dir = directory
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"host_{host_id:05d}.hb")

    def beat(self, step: int) -> None:
        with open(self.path, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)

    @staticmethod
    def dead_hosts(directory: str, timeout_s: float, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        dead = []
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".hb"):
                continue
            path = os.path.join(directory, name)
            try:
                with open(path) as f:
                    t = json.load(f)["t"]
            except Exception:
                t = 0.0
            if now - t > timeout_s:
                dead.append(int(name.split("_")[1].split(".")[0]))
        return dead


class Supervisor:
    """Run a step function with failure → checkpoint-restore recovery: the
    counterpart of ``repro.runtime.health.Supervisor``.

    ``step_fn(state, batch) -> (state, metrics)`` may raise (a device fault
    surfaces as an exception, at the latest when the loss is read); the
    supervisor restores the last checkpoint, rewinds the data pipeline and
    continues. ``recoveries`` counts the restores. One repair of what the
    reference hides: when no checkpoint exists to restore, the step's own
    exception is raised (the restore's ``FileNotFoundError`` on its
    ``__cause__``), not the restore's."""

    def __init__(self, ckpt_manager, data, save_every: int = 10):
        self.ckpt = ckpt_manager
        self.data = data
        self.save_every = save_every
        self.monitor = StepTimeMonitor()
        self.recoveries = 0

    def run(
        self,
        state,
        step_fn: Callable,
        n_steps: int,
        restore_fn: Callable,
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
    ):
        step = int(state["step"]) if "step" in state else 0
        while step < n_steps:
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            try:
                state, metrics = step_fn(state, batch)
                metrics["loss"].item()  # waits for the step; a device fault raises here
            except Exception as failure:
                # restore the last durable state, rewind the data, retry
                self.ckpt.wait()
                try:
                    state, meta = restore_fn()
                except FileNotFoundError as missing:
                    raise failure from missing
                self.recoveries += 1
                step = meta["step"]
                self.data.skip_to(meta["extra"].get("data_step", step))
                continue
            self.monitor.record(step, time.perf_counter() - t0)
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            if step % self.save_every == 0:
                self.ckpt.save(step, state, extra={"data_step": self.data.step})
        self.ckpt.wait()
        return state
