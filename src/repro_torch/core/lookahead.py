"""Short-lookahead workload information Ŵ_i^H(k) (Section 4).

The paper's key informational insight: BF-IO does NOT need total-length
prediction of *new* jobs; it needs only a short-horizon description of the
near-future evolution of *currently active* jobs — e.g. "will this request
finish within the next h steps?".

Predictors produce, for a set of jobs with known current workload w and age,
a matrix ``traj[(n, H+1)]`` with traj[i, h] = predicted workload contribution
of job i at step k+h (h=0 is the current step; zero after predicted finish).

Under the LLM drift model, an alive job's contribution at k+h is
``w_i + sum(delta over the next h steps)``; prediction reduces to the
finish-time indicator / survival probability.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np

from .workload import DriftModel

__all__ = [
    "Predictor",
    "OraclePredictor",
    "GeometricPredictor",
    "NoisyOraclePredictor",
    "trajectories",
]


def _growth(drift: DriftModel, k: int, H: int) -> np.ndarray:
    """Cumulative drift over the window: g[h] = sum delta_{k+1..k+h}."""
    g = np.zeros(H + 1, dtype=np.float64)
    for h in range(1, H + 1):
        g[h] = g[h - 1] + drift.increment(k + h)
    return g


class Predictor(Protocol):
    """Predicts survival weights within the lookahead window."""

    def survival(self, remaining: np.ndarray, ages: np.ndarray,
                 H: int, rng: Optional[np.random.Generator]) -> np.ndarray:
        """Return (n, H+1) matrix p[i, h] in [0,1]: predicted probability
        (or indicator) that job i is still running at step k+h.

        ``remaining``: true remaining steps (oracle inputs may use it;
        prediction-free ones must not). ``ages``: steps already processed.
        """
        ...


@dataclasses.dataclass(frozen=True)
class OraclePredictor:
    """Clairvoyant within the window: knows finish times <= H ahead.

    This is the paper's idealized Ŵ: exact short-horizon completion info —
    far weaker than full-length prediction (still unknowable beyond H).
    """

    def survival(self, remaining, ages, H, rng=None):
        remaining = np.asarray(remaining, dtype=np.int64)
        h = np.arange(H + 1)[None, :]
        return (h < remaining[:, None]).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class GeometricPredictor:
    """Prediction-free prior: decode lengths ~ Geo(p) are memoryless, so the
    survival probability at horizon h is (1-p)^h regardless of age.

    This realizes 'even manual rules' from the paper — no learned model.
    """

    p: float

    def survival(self, remaining, ages, H, rng=None):
        n = len(np.asarray(remaining))
        h = np.arange(H + 1, dtype=np.float64)[None, :]
        return np.broadcast_to((1.0 - self.p) ** h, (n, H + 1)).copy()


@dataclasses.dataclass(frozen=True)
class NoisyOraclePredictor:
    """Oracle whose finish-time estimates are corrupted: with probability
    ``flip`` a job's predicted remaining time is resampled geometrically.
    Models realistic lightweight finish-signal classifiers."""

    flip: float
    p: float

    def survival(self, remaining, ages, H, rng=None):
        rng = rng or np.random.default_rng(0)
        remaining = np.asarray(remaining, dtype=np.int64).copy()
        n = len(remaining)
        bad = rng.random(n) < self.flip
        if bad.any():
            remaining = remaining.copy()
            remaining[bad] = rng.geometric(self.p, size=int(bad.sum()))
        h = np.arange(H + 1)[None, :]
        return (h < remaining[:, None]).astype(np.float64)


def trajectories(
    current_w: np.ndarray,
    remaining: np.ndarray,
    ages: np.ndarray,
    *,
    drift: DriftModel,
    k: int,
    H: int,
    predictor: Predictor,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Ŵ_i^H(k) as an (n, H+1) matrix of predicted contributions.

    traj[i, h] = (w_i + growth[h]) * survival[i, h].
    """
    current_w = np.asarray(current_w, dtype=np.float64)
    n = current_w.shape[0]
    if n == 0:
        return np.zeros((0, H + 1), dtype=np.float64)
    surv = predictor.survival(remaining, ages, H, rng)
    growth = _growth(drift, k, H)[None, :]
    return (current_w[:, None] + growth) * surv
