"""Solvers for the step-wise integer optimization (IO) of Section 4.

At step k the scheduler chooses disjoint admit-sets {S_g(k)} minimizing

    J(S(k)) = sum_{h=0..H} Imbalance(k+h)
            = sum_h [ G * max_g Lhat_g(k+h) - sum_g Lhat_g(k+h) ]

subject to |S_g| <= cap[g] and |S| = U(k) = min(|R_wait|, sum_g cap[g]).

Representation
--------------
* ``base``  : (G, H+1) predicted per-worker load trajectories of the jobs
              already resident (h=0 is the current step, after growth and
              completions, before admission).
* ``cands`` : (n, H+1) predicted contribution trajectories of waiting
              candidates, conditional on being admitted at step k.
* An assignment is an int vector a[n] with a[i] in {-1 (not admitted),
  0..G-1}.

The exact (IO) is exponential (the paper's Algorithm 1 enumerates feasible
allocations).  The worst-case theory only needs the minimizer's
*separation / s_max-balance* property (Lemma 1 / Lemma 2), which an
exchange/swap argument produces — so the production solver is greedy
LPT-style construction followed by improving-swap local search: the local
search is literally the proofs' exchange argument run to a fixed point.
``solve_exact`` brute-forces tiny instances for tests.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

__all__ = [
    "objective",
    "solve_greedy",
    "local_search",
    "solve_io",
    "solve_exact",
]


def objective(base: np.ndarray, cands: np.ndarray, assign: np.ndarray) -> float:
    """J(S(k;x)) for an assignment vector (Section 4, Eq. (IO) objective)."""
    base = np.asarray(base, dtype=np.float64)
    G, _ = base.shape
    loads = base.copy()
    for i, g in enumerate(assign):
        if g >= 0:
            loads[g] += cands[i]
    return float((G * loads.max(axis=0) - loads.sum(axis=0)).sum())


def _loads_from(base: np.ndarray, cands: np.ndarray,
                assign: np.ndarray) -> np.ndarray:
    loads = np.asarray(base, dtype=np.float64).copy()
    for i, g in enumerate(assign):
        if g >= 0:
            loads[g] += cands[i]
    return loads


def solve_greedy(
    base: np.ndarray,
    caps: np.ndarray,
    cands: np.ndarray,
    n_admit: Optional[int] = None,
) -> np.ndarray:
    """LPT-style greedy: largest candidate first to the worker whose
    windowed max-load increase is smallest (ties -> lower current load).

    Returns the assignment vector a[n] in {-1, 0..G-1}.
    """
    base = np.asarray(base, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.int64).copy()
    cands = np.asarray(cands, dtype=np.float64)
    G, W = base.shape
    n = cands.shape[0]
    U = int(min(n, caps.sum())) if n_admit is None else int(n_admit)
    U = min(U, n, int(caps.sum()))

    assign = np.full(n, -1, dtype=np.int64)
    if U == 0 or n == 0:
        return assign

    loads = base.copy()                       # (G, W)
    order = np.argsort(-cands.sum(axis=1), kind="stable")  # largest total first
    admitted = 0
    for i in order:
        if admitted >= U:
            break
        c = cands[i]                          # (W,)
        # score of placing i on worker g: sum_h max(top1_excluding_g, loads[g]+c)
        top1 = loads.max(axis=0)              # (W,)
        arg1 = loads.argmax(axis=0)           # (W,)
        # second max per h for the exclusion trick
        tmp = loads.copy()
        tmp[arg1, np.arange(W)] = -np.inf
        top2 = tmp.max(axis=0) if G > 1 else np.full(W, -np.inf)
        cand_loads = loads + c[None, :]       # (G, W)
        excl = np.where(np.arange(G)[:, None] == arg1[None, :],
                        top2[None, :], top1[None, :])
        scores = np.maximum(excl, cand_loads).sum(axis=1)  # (G,)
        scores = np.where(caps > 0, scores, np.inf)
        # tie-break on smaller current total load
        g = int(np.lexsort((loads.sum(axis=1), scores))[0])
        if not np.isfinite(scores[g]):
            break
        assign[i] = g
        loads[g] += c
        caps[g] -= 1
        admitted += 1
    return assign


def local_search(
    base: np.ndarray,
    caps: np.ndarray,
    cands: np.ndarray,
    assign: np.ndarray,
    max_iters: int = 256,
) -> np.ndarray:
    """Improving-exchange local search — the exchange argument of
    Lemma 1 / Lemma 2 run to a fixed point (this is what produces the
    s_max-balanced / separation property the theory relies on).

    Per iteration: pick the worker p with the largest windowed load whose
    moves haven't reached a fixed point; consider (all vectorized with a
    top-3 per-column exclusion trick):
      1. relocating each p-candidate to any worker with residual capacity;
      2. swapping each p-candidate with any admitted candidate elsewhere;
      3. swapping each p-candidate with an unadmitted candidate.
    Apply the single best improving move, else try the next-heaviest worker;
    stop when no worker admits an improving move.
    """
    base = np.asarray(base, dtype=np.float64)
    cands = np.asarray(cands, dtype=np.float64)
    caps0 = np.asarray(caps, dtype=np.int64)
    assign = np.asarray(assign, dtype=np.int64).copy()
    G, W = base.shape
    n = cands.shape[0]
    if n == 0 or G < 2:
        return assign

    loads = _loads_from(base, cands, assign)
    used = np.bincount(assign[assign >= 0], minlength=G)
    resid = caps0 - used
    max_wait_considered = 256

    def J(l: np.ndarray) -> float:
        return float((G * l.max(axis=0) - l.sum(axis=0)).sum())

    def top3(l: np.ndarray):
        """Per-column top-3 values and their row indices."""
        k = min(3, G)
        idx = np.argsort(-l, axis=0)[:k]                   # (k, W)
        val = np.take_along_axis(l, idx, axis=0)           # (k, W)
        if k < 3:
            pad_v = np.full((3 - k, W), -np.inf)
            pad_i = np.full((3 - k, W), -1, dtype=np.int64)
            val = np.vstack([val, pad_v])
            idx = np.vstack([idx, pad_i])
        return val, idx

    def excl_two(val, idx, a, b):
        """max over rows excluding rows a and b, per column.

        a, b broadcastable int arrays with trailing shape (..., 1) vs (W,)."""
        e1 = (idx[0][None, :] != a) & (idx[0][None, :] != b)
        e2 = (idx[1][None, :] != a) & (idx[1][None, :] != b)
        return np.where(e1, val[0][None, :],
                        np.where(e2, val[1][None, :], val[2][None, :]))

    cur = J(loads)
    for _ in range(max_iters):
        order = np.argsort(-loads.sum(axis=1))
        # Everything below is invariant across the p-loop (loads/assign only
        # change when a move is applied, which restarts the outer loop), so
        # gather the move-target pools and top-3 exclusion tables once and
        # mask per-p instead of re-compacting per worker.
        val, idx = top3(loads)
        tot = loads.sum(axis=0)
        gs_all = np.nonzero(resid > 0)[0]                   # relocate targets
        lg_all = loads[gs_all]                              # (ng, W)
        Ja = np.nonzero(assign >= 0)[0]                     # admitted pool
        ga = assign[Ja]                                     # (na,)
        ca = cands[Ja]                                      # (na, W)
        la = loads[ga]                                      # (na, W)
        Jw = np.nonzero(assign < 0)[0][:max_wait_considered]
        cw = cands[Jw]                                      # (nw, W)
        applied = False
        for p in order:
            p = int(p)
            Ip = np.nonzero(assign == p)[0]
            if len(Ip) == 0:
                continue
            lp = loads[p]
            cp = cands[Ip]                                  # (np_, W)
            best = (cur - 1e-9, None)

            # 1. relocate i in Ip -> worker g with resid > 0 (g == p masked)
            if len(gs_all) > 0:
                lp_new = lp[None, None, :] - cp[:, None, :]        # (np_,1,W)
                lg_new = lg_all[None, :, :] + cp[:, None, :]       # (np_,ng,W)
                ex = excl_two(val, idx, p, gs_all.reshape(1, -1, 1))
                mx = np.maximum(ex, np.maximum(lp_new, lg_new))
                vals = (G * mx - tot[None, None, :]).sum(axis=2)   # (np_,ng)
                vals[:, gs_all == p] = np.inf
                ai, ag = np.unravel_index(int(np.argmin(vals)), vals.shape)
                if vals[ai, ag] < best[0]:
                    best = (float(vals[ai, ag]),
                            ("rel", int(Ip[ai]), int(gs_all[ag])))

            # 2. swap i in Ip with admitted j on another worker (g_j == p
            #    masked)
            if len(Ja) > 0:
                d = ca[None, :, :] - cp[:, None, :]                # (np_,na,W)
                lp_new = lp[None, None, :] + d
                lg_new = la[None, :, :] - d
                ex = excl_two(val, idx, p, ga.reshape(1, -1, 1))
                mx = np.maximum(ex, np.maximum(lp_new, lg_new))
                vals = (G * mx - tot[None, None, :]).sum(axis=2)
                vals[:, ga == p] = np.inf
                ai, aj = np.unravel_index(int(np.argmin(vals)), vals.shape)
                if vals[ai, aj] < best[0]:
                    best = (float(vals[ai, aj]),
                            ("swap", int(Ip[ai]), int(Ja[aj])))

            # 3. swap i in Ip with unadmitted j (changes the sum term)
            if len(Jw) > 0:
                d = cw[None, :, :] - cp[:, None, :]                # (np_,nw,W)
                lp_new = lp[None, None, :] + d
                ex = excl_two(val, idx, p, p)
                mx = np.maximum(ex, lp_new)
                vals = (G * mx - (tot[None, None, :] + d)).sum(axis=2)
                ai, aj = np.unravel_index(int(np.argmin(vals)), vals.shape)
                if vals[ai, aj] < best[0]:
                    best = (float(vals[ai, aj]),
                            ("adm", int(Ip[ai]), int(Jw[aj])))

            if best[1] is None:
                continue
            kind, i, x = best[1]
            if kind == "rel":
                g = x
                loads[p] -= cands[i]
                loads[g] += cands[i]
                assign[i] = g
                resid[p] += 1
                resid[g] -= 1
            elif kind == "swap":
                j = x
                g = int(assign[j])
                loads[p] += cands[j] - cands[i]
                loads[g] += cands[i] - cands[j]
                assign[i], assign[j] = g, p
            else:  # adm
                j = x
                loads[p] += cands[j] - cands[i]
                assign[j] = p
                assign[i] = -1
            cur = best[0]
            applied = True
            break
        if not applied:
            break
    return assign


def solve_io(
    base: np.ndarray,
    caps: np.ndarray,
    cands: np.ndarray,
    n_admit: Optional[int] = None,
    refine: bool = True,
    max_iters: int = 256,
) -> np.ndarray:
    """Production BF-IO solver: greedy construction + swap refinement."""
    assign = solve_greedy(base, caps, cands, n_admit=n_admit)
    if refine and cands.shape[0] > 1:
        assign = local_search(base, caps, cands, assign, max_iters=max_iters)
    return assign


def solve_exact(
    base: np.ndarray,
    caps: np.ndarray,
    cands: np.ndarray,
    n_admit: Optional[int] = None,
) -> tuple[np.ndarray, float]:
    """Brute-force optimal (IO) solution — tiny instances only (tests)."""
    base = np.asarray(base, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.int64)
    cands = np.asarray(cands, dtype=np.float64)
    G = base.shape[0]
    n = cands.shape[0]
    U = int(min(n, caps.sum())) if n_admit is None else int(n_admit)
    if n > 10 or G > 4:
        raise ValueError("solve_exact is for tiny instances only")

    best: tuple[float, Optional[np.ndarray]] = (np.inf, None)
    for subset in itertools.combinations(range(n), U):
        for placement in itertools.product(range(G), repeat=U):
            used = np.bincount(placement, minlength=G)
            if np.any(used > caps):
                continue
            a = np.full(n, -1, dtype=np.int64)
            for idx, g in zip(subset, placement):
                a[idx] = g
            v = objective(base, cands, a)
            if v < best[0] - 1e-12:
                best = (v, a)
    assert best[1] is not None, "no feasible assignment"
    return best[1], best[0]
