"""Budgets and the Eq.-7 fitness (paper §3.4).

  distance_to_budget = Σ_m α_m · (Des_m − Bud_m) / Bud_m ,
  m ∈ {performance, power, area}

α dampens metrics that already meet their budget so the explorer keeps a small
incentive to bank slack (the paper: "a dampening factor to the metrics already
meeting budget"). Convergence is declared on the *undampened* city-block
distance of unmet metrics reaching zero (§5: "distance to goal").

Latency budgets are per workload (Table 4a); power/area budgets are
system-wide (sum over all workload components).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .phase_sim import SimResult

METRICS = ("latency", "power", "area")


@dataclasses.dataclass(frozen=True)
class Budget:
    latency_s: Dict[str, float]  # per workload
    power_w: float
    area_mm2: float

    def scaled(self, factor: float) -> "Budget":
        """Budget relaxation for the §6.1 case study (1X/2X/4X)."""
        return Budget(
            latency_s={k: v * factor for k, v in self.latency_s.items()},
            power_w=self.power_w * factor,
            area_mm2=self.area_mm2 * factor,
        )


@dataclasses.dataclass
class Distance:
    per_metric: Dict[str, float]  # signed normalized (Des-Bud)/Bud, worst wl for latency
    per_workload_latency: Dict[str, float]

    def fitness(self, alpha_met: float = 0.05) -> float:
        """Eq. 7 with dampening α on met metrics."""
        out = 0.0
        for m, d in self.per_metric.items():
            out += d if d > 0 else alpha_met * d
        return out

    def city_block(self) -> float:
        """Normalized city-block distance of *unmet* metrics (Fig. 9 y-axis)."""
        return sum(max(0.0, d) for d in self.per_metric.values()) + sum(
            max(0.0, d) for d in self.per_workload_latency.values()
        )

    def converged(self) -> bool:
        return self.city_block() <= 0.0

    def farthest_metric(self) -> str:
        """The metric contributing most to the distance — FARSI 'typically
        pick[s] the metric farthest from its budget' (§3.3)."""
        cand = dict(self.per_metric)
        return max(cand, key=lambda m: cand[m])


def distance(result: SimResult, budget: Budget) -> Distance:
    per_wl = {
        w: (result.workload_latency_s.get(w, 0.0) - b) / b
        for w, b in budget.latency_s.items()
    }
    per_metric = {
        "latency": max(per_wl.values()) if per_wl else 0.0,
        "power": (result.power_w - budget.power_w) / budget.power_w,
        "area": (result.area_mm2 - budget.area_mm2) / budget.area_mm2,
    }
    return Distance(per_metric=per_metric, per_workload_latency=per_wl)
