"""GPU/TPU power model and the energy theory of Section 5.2.

Power draw is sublinear in utilization (Eq. 7):

    P(u) = P_idle + (P_max - P_idle) * u**gamma,   gamma in (0, 1)

with u = mfu/mfu_sat = L_g / L_max within the synchronized phase (Eqs. 8–9).

Theorem 4 machinery: the exact energy decomposition (C47), the sandwich
bound (C49), the saving bound (16), and Corollary 1's asymptotic limit (18).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "PowerModel",
    "A100_POWER",
    "TPU_V5E_POWER",
    "energy_decomposition",
    "energy_sandwich",
    "saving_bound",
    "asymptotic_saving",
]


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Eq. (7) with the calibration of Appendix D.1."""

    p_idle: float = 100.0     # W
    p_max: float = 400.0      # W
    gamma: float = 0.7
    mfu_sat: float = 0.45
    name: str = "a100"

    def power(self, u) -> np.ndarray:
        """Instantaneous power at utilization fraction u in [0, 1]."""
        u = np.clip(np.asarray(u, dtype=np.float64), 0.0, 1.0)
        return self.p_idle + (self.p_max - self.p_idle) * u ** self.gamma

    @property
    def c_gamma(self) -> float:
        """C_gamma = (1-gamma) P_max + gamma P_idle  (Eq. 15)."""
        return (1.0 - self.gamma) * self.p_max + self.gamma * self.p_idle

    @property
    def d_gamma(self) -> float:
        """D_gamma = (1-gamma)(P_max - P_idle)  (Eq. 15)."""
        return (1.0 - self.gamma) * (self.p_max - self.p_idle)


A100_POWER = PowerModel()  # paper-faithful: 100 W / 400 W / gamma 0.7
# TPU v5e preset (beyond-paper hardware adaptation; envelope numbers):
TPU_V5E_POWER = PowerModel(p_idle=74.0, p_max=197.0, gamma=0.7,
                           mfu_sat=0.45, name="tpu_v5e")


def energy_decomposition(
    loads_per_step: list[np.ndarray] | np.ndarray,
    kappa_att: float,
    pm: PowerModel,
) -> dict:
    """Exact identity (C47):

    E = kappa*P_max*W + kappa*P_idle*ImbTot + kappa*(P_max-P_idle)*X,
    X = sum_{k,g} L*(k) (u^gamma - u),   0 <= X <= (1-gamma) ImbTot.
    """
    e = w = imb = x = 0.0
    for L in loads_per_step:
        L = np.asarray(L, dtype=np.float64)
        lmax = L.max()
        if lmax <= 0:
            continue
        u = L / lmax
        tau = kappa_att * lmax
        e += tau * pm.power(u).sum()
        w += L.sum()
        imb += (lmax - L).sum()
        x += lmax * (u ** pm.gamma - u).sum()
    return {
        "energy": e,
        "W": w,
        "ImbTot": imb,
        "X": x,
        "identity_rhs": kappa_att * (pm.p_max * w + pm.p_idle * imb
                                     + (pm.p_max - pm.p_idle) * x),
    }


def energy_sandwich(W: float, imb_tot: float, kappa_att: float,
                    pm: PowerModel) -> tuple[float, float]:
    """(C49): kappa(P_max W + P_idle ImbTot) <= E <= kappa(P_max W + C_gamma ImbTot)."""
    lo = kappa_att * (pm.p_max * W + pm.p_idle * imb_tot)
    hi = kappa_att * (pm.p_max * W + pm.c_gamma * imb_tot)
    return lo, hi


def saving_bound(alpha: float, eta_sum: float, pm: PowerModel) -> float:
    """Theorem 4, Eq. (16): guaranteed synchronized-phase saving fraction
    given imbalance improvement factor alpha > 1 and baseline normalized
    imbalance eta_sum = ImbTot(pi0)/W."""
    if alpha <= 1.0:
        return 0.0
    num = pm.p_idle * (1.0 - 1.0 / alpha) - pm.d_gamma / alpha
    den = pm.p_max / max(eta_sum, 1e-12) + pm.c_gamma
    return num / den


def asymptotic_saving(pm: PowerModel) -> float:
    """Corollary 1, Eq. (18): limit saving fraction as G -> infinity.

    For A100 (100/400/0.7): 100 / (0.3*400 + 0.7*100) = 100/190 ~= 52.6 %.
    """
    return pm.p_idle / ((1.0 - pm.gamma) * pm.p_max + pm.gamma * pm.p_idle)
