"""Evaluation metrics of Sections 3 and 6.3."""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["step_imbalance", "SimMetrics"]


def step_imbalance(loads: np.ndarray) -> float:
    """Imbalance(k) = sum_g (L_max - L_g) = G * L_max - sum_g L_g  (Eq. 2)."""
    loads = np.asarray(loads, dtype=np.float64)
    G = loads.shape[0]
    return float(G * loads.max() - loads.sum())


@dataclasses.dataclass
class SimMetrics:
    """Aggregated results of one simulation run (Section 6.3)."""

    policy: str
    steps: int
    avg_imbalance: float          # Eq. (20)
    total_imbalance: float        # ImbTot, Eq. (12)
    throughput: float             # tokens/s, Eq. (21)
    tpot: float                   # s/token, Eq. (22)
    energy_joules: float          # Eq. (6)/(10)
    makespan: float               # total wall-clock
    total_work: float             # W(I), Eq. (11) — policy independent
    completed: int
    mean_idle_frac: float         # Fig. 1-style barrier idle fraction
    avg_power_watts: float

    @property
    def eta_sum(self) -> float:
        """Normalized imbalance level eta_sum (Eq. 13)."""
        return self.total_imbalance / max(self.total_work, 1e-12)

    def row(self) -> dict:
        return {
            "policy": self.policy,
            "steps": self.steps,
            "avg_imbalance": self.avg_imbalance,
            "throughput_tok_s": self.throughput,
            "tpot_s": self.tpot,
            "energy_MJ": self.energy_joules / 1e6,
            "makespan_s": self.makespan,
            "idle_frac": self.mean_idle_frac,
            "avg_power_W": self.avg_power_watts,
            "eta_sum": self.eta_sum,
            "completed": self.completed,
        }

    def __str__(self) -> str:
        return (
            f"{self.policy:>10s}: imb={self.avg_imbalance:.4g} "
            f"thr={self.throughput:.4g} tok/s tpot={self.tpot:.4g} s "
            f"E={self.energy_joules/1e6:.4g} MJ idle={self.mean_idle_frac:.1%}"
        )
