"""Closed-form theoretical quantities from Section 5.

These are the *formulas* of Theorems 1-3, Remark 1 / Eq. (17) and
Corollary 1, used by benchmarks/theory_validation.py to check that measured
imbalance-improvement ratios scale as the theory predicts.
"""
from __future__ import annotations

import math


from .energy import PowerModel, asymptotic_saving, saving_bound

__all__ = [
    "iir_homogeneous",
    "iir_geometric",
    "iir_general_drift",
    "snapshot_sigma",
    "eta_sum_fcfs_lower",
    "energy_saving_guarantee",
    "predicted_fcfs_imbalance",
    "predicted_bfio_imbalance",
]


def snapshot_sigma(sigma_s: float, p: float) -> float:
    """sigma_snap^2 = sigma_s^2 + (1-p)/p^2 (Theorem 2 proof, Eq. C15)."""
    return math.sqrt(sigma_s ** 2 + (1.0 - p) / p ** 2)


def iir_homogeneous(B: int, G: int, kappa0: float, c: float = 1.0) -> float:
    """Theorem 1 lower bound: c * kappa0 * sqrt(B log G) * G/(G-1)."""
    if G < 2:
        return 1.0
    return c * kappa0 * math.sqrt(B * math.log(G)) * G / (G - 1)


def iir_geometric(B: int, G: int, p: float, sigma_s: float, s_max: float,
                  c: float = 1.0) -> float:
    """Theorem 2 lower bound:
    c * (p/s_max) * sqrt(sigma_s^2 + (1-p)/p^2) * G/(G-1) * sqrt(B log G)."""
    if G < 2:
        return 1.0
    return (c * p / s_max * snapshot_sigma(sigma_s, p)
            * G / (G - 1) * math.sqrt(B * math.log(G)))


def iir_general_drift(B: int, G: int, p: float, sigma_s: float, s_max: float,
                      c: float = 1.0) -> float:
    """Theorem 3 lower bound: c * p*sigma_s/s_max * G/(G-1) * sqrt(B log G)."""
    if G < 2:
        return 1.0
    return (c * p * sigma_s / s_max * G / (G - 1)
            * math.sqrt(B * math.log(G)))


def predicted_fcfs_imbalance(B: int, G: int, sigma_s: float, p: float,
                             c: float = 1.0) -> float:
    """FCFS stationary expected imbalance ~ c*G*sigma_snap*sqrt(B log G)
    (Eq. C18)."""
    return c * G * snapshot_sigma(sigma_s, p) * math.sqrt(B * math.log(max(G, 2)))


def predicted_bfio_imbalance(G: int, s_max: float, p: float) -> float:
    """BF-IO long-run average imbalance <= (G-1) * s_max / p (Lemma 4)."""
    return (G - 1) * s_max / p


def eta_sum_fcfs_lower(B: int, G: int, mu_s: float, sigma_s: float,
                       p: float, c: float = 1.0) -> float:
    """Eq. (17): eta_sum(FCFS) >~ sigma_snap/(mu_s + (1-p)/p) * sqrt(log G / B)."""
    mu_u = mu_s + (1.0 - p) / p
    return c * snapshot_sigma(sigma_s, p) / mu_u * math.sqrt(
        math.log(max(G, 2)) / B)


def energy_saving_guarantee(
    B: int, G: int, p: float, mu_s: float, sigma_s: float, s_max: float,
    pm: PowerModel, c_alpha: float = 1.0, c_eta: float = 1.0,
) -> dict:
    """Remark 1 + Corollary 1: the explicit saving guarantee and its G->inf
    limit for the given power model."""
    alpha = iir_geometric(B, G, p, sigma_s, s_max, c=c_alpha)
    eta = eta_sum_fcfs_lower(B, G, mu_s, sigma_s, p, c=c_eta)
    return {
        "alpha": alpha,
        "eta_sum_lower": eta,
        "saving_bound": saving_bound(alpha, eta, pm),
        "asymptotic_saving": asymptotic_saving(pm),
    }
