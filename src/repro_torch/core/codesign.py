"""Co-design ledger (paper §5.3, Fig. 10).

FARSI "uses co-design by not being fixated on one optimization for too long"
— every iteration re-selects its focus along four vectors:

  1. metric          (performance / power / area)
  2. workload        (audio / cava / ed / ...)
  3. comp ↔ comm     (is the targeted bottleneck a PE or a Mem/NoC?)
  4. optimization    high-level (mapping/allocation) ↔ low-level (knob tuning),
                     and the concrete move kind

The ledger records the focus tuple per iteration; *deployment rate* of a
vector = how often consecutive iterations switched focus on it (Fig. 10b);
*convergence contribution* = mean distance improvement in iterations that
switched vs. did not (Fig. 10c).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .moves import HIGH_LEVEL

VECTORS = ("metric", "workload", "comm_comp", "opt_level")


@dataclasses.dataclass
class FocusRecord:
    iteration: int
    metric: str
    workload: str
    comm_comp: str  # "comp" | "comm"
    move: str
    distance_before: float
    distance_after: float

    @property
    def opt_level(self) -> str:
        return "high" if self.move in HIGH_LEVEL else "low"

    def vector_value(self, vector: str) -> str:
        return {
            "metric": self.metric,
            "workload": self.workload,
            "comm_comp": self.comm_comp,
            "opt_level": self.opt_level,
        }[vector]


class CodesignLedger:
    def __init__(self) -> None:
        self.records: List[FocusRecord] = []

    def log(self, rec: FocusRecord) -> None:
        self.records.append(rec)

    # ---- Fig. 10b: deployment (switch) rate per vector -------------------
    def switch_rate(self, vector: str) -> float:
        if len(self.records) < 2:
            return 0.0
        switches = sum(
            1
            for a, b in zip(self.records, self.records[1:])
            if a.vector_value(vector) != b.vector_value(vector)
        )
        return switches / (len(self.records) - 1)

    # ---- Fig. 10c: convergence rate attribution --------------------------
    def convergence_contribution(self, vector: str) -> float:
        """Mean relative distance improvement in iterations that switched
        focus on ``vector`` (positive = switching helped)."""
        gains = []
        for a, b in zip(self.records, self.records[1:]):
            if a.vector_value(vector) != b.vector_value(vector):
                if b.distance_before > 0:
                    gains.append(
                        (b.distance_before - b.distance_after) / b.distance_before
                    )
        return sum(gains) / len(gains) if gains else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            v: {
                "switch_rate": self.switch_rate(v),
                "convergence_contribution": self.convergence_contribution(v),
            }
            for v in VECTORS
        }

    def move_histogram(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.move] = out.get(r.move, 0) + 1
        return out


def aggregate_ledgers(ledgers: List["CodesignLedger"]) -> Dict[str, float]:
    """Campaign-level Fig.-10 aggregates: mean switch rate and convergence
    contribution per co-design vector over a grid of runs (runs with too few
    records contribute their zeros, like the per-run summaries do). Keys are
    flat (``codesign_switch_rate_<vector>`` / ``codesign_contribution_
    <vector>``) so they merge into `Campaign`'s scalar aggregate dict."""
    out: Dict[str, float] = {}
    n = max(len(ledgers), 1)
    for v in VECTORS:
        out[f"codesign_switch_rate_{v}"] = (
            sum(l.switch_rate(v) for l in ledgers) / n
        )
        out[f"codesign_contribution_{v}"] = (
            sum(l.convergence_contribution(v) for l in ledgers) / n
        )
    return out
