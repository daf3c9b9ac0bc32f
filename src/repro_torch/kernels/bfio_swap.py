"""Pairwise swap-score search for BF-IO refinement, batched over clusters.

One refinement step of the exchange argument needs, for every admitted
candidate pair (i, j) assigned to different workers, the windowed max-load
objective *after* exchanging them:

    val[i, j] = sum_h max( max_{g != g_i, g_j} loads[g, h],
                           loads[g_i, h] + c_j[h] - c_i[h],
                           loads[g_j, h] + c_i[h] - c_j[h] )

reduced per row to ``best_val[i] = min_j val[i, j]`` and ``best_j[i]``,
its first minimizer (the global argmin over ``best_val`` then reproduces
the dense row-major tie-break exactly).  Infeasible pairs score +inf.

Replaces the Pallas TPU kernel ``repro/kernels/bfio_swap.py:
swap_best_pallas``.  Every function here takes an optional leading cluster
axis C (``loads (C, G, W)``, ``cands (C, N, W)``, ``assign``/``valid``
``(C, N)``), so the batched solver (``bfio_assign_batch``: the fleet
router, and ``pod_bfio`` with C = pods) runs on the kernel; the reference
kernel was never batched.

* :func:`swap_best` — the wrapper: on a CPU tensor it runs
  :func:`swap_best_plain`; on a CUDA tensor it makes one launch of the
  hand-written kernel ``csrc/bfio_swap.cu`` on the raw inputs, with no
  PyTorch op before it (the kernel computes :func:`swap_prep`'s prepass
  itself; one warp per row, j tiles staged in shared memory with
  ``cp.async``, each lane's running argmin merged to the first minimizer
  by warp shuffles), or raises.  ``swap_best.launches`` counts launches.
  The kernel is bound by its launch at the router's shapes (C=1, N=64,
  W=1).
* :func:`swap_best_plain` — the plain PyTorch version, tiled over row
  blocks with the full j extent per block: the counterpart of the
  reference's ``swap_best_xla``.
* :func:`swap_best_dense` — the O(N^2 W) dense oracle, the counterpart of
  ``repro/kernels/ref.py:bfio_swap_best_ref``.

The reference's TPU-only options are dropped: ``interpret`` (Pallas
interpret mode) and ``pad_lanes`` (padding W to the TPU's 128 lanes).

Bit-exactness.  All three return bit-identical ``best_val`` (and
``best_j`` on finite rows), and equal the reference's XLA path on its
fixtures: the operations follow the reference's order (``d = c_j - c_i``,
``la = lo_i + d``, ``lb = lo_j - d``, ``max(ex, max(la, lb))``) and the
W-sum is a left fold ``w = 0, 1, ..., W-1`` (:func:`wsum`), which is the
order XLA's CPU reduction takes for these widths (``torch.sum`` is not).
The max-excluding-two-rows term uses the top-3 loads per window slot:
at most two rows are ever excluded.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["wsum", "swap_prep", "swap_best", "swap_best_plain",
           "swap_best_dense"]


def wsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a left fold (fixed order, the one every
    solver reduction over the window uses)."""
    out = x[..., 0]
    for w in range(1, x.shape[-1]):
        out = out + x[..., w]
    return out


def _batched(loads, cands, assign, valid):
    """Add the cluster axis to unbatched inputs; returns (args, squeeze)."""
    if loads.dim() == 2:
        return (loads[None], cands[None], assign[None], valid[None]), True
    return (loads, cands, assign, valid), False


def swap_prep(loads, cands, assign, valid):
    """Shared O(G W + N W) prepass, in plain PyTorch on the inputs' device.

    Returns (lo, ga, adm, vtop, ttop), each with the cluster axis when
    the inputs have one:
      lo   : (N, W) f32   load row of each candidate's worker (0 if
                          unadmitted)
      ga   : (N,)   i32   assigned worker (clipped to 0 for unadmitted)
      adm  : (N,)  bool   admitted mask
      vtop : (3, W) f32   top-3 load values per window slot
      ttop : (2, W) i32   rows holding the top-1 / top-2 values
    """
    (loads, cands, assign, valid), squeeze = _batched(
        loads, cands, assign, valid)
    loads = loads.float()
    C, G, W = loads.shape
    N = cands.shape[1]
    adm = (assign >= 0) & valid
    ga = assign.clamp(min=0).int()
    rows = loads.gather(1, ga.long()[:, :, None].expand(C, N, W))
    lo = torch.where(adm[:, :, None], rows, torch.zeros((), device=rows.device))
    # stable: among equal loads the lower row ranks first, as jnp.argsort
    idx = torch.argsort(-loads, dim=1, stable=True)          # (C, G, W)
    t = [idx[:, min(k, G - 1)] for k in range(3)]           # (C, W) each
    vtop = torch.stack([loads.gather(1, tk[:, None])[:, 0] for tk in t], 1)
    ttop = torch.stack(t[:2], 1).int()
    out = (lo, ga, adm, vtop, ttop)
    return tuple(x[0] for x in out) if squeeze else out


def _pair_vals(ci, li, gai, admi, cj, lj, gaj, admj, vtop, ttop):
    """Swap objective for an (I, J) block of each cluster: (C, I, J)."""
    diff = cj[:, None, :, :] - ci[:, :, None, :]            # (C, I, J, W)
    la = li[:, :, None, :] + diff                           # g_i row after
    lb = lj[:, None, :, :] - diff                           # g_j row after
    ga4 = gai[:, :, None, None]
    gb4 = gaj[:, None, :, None]
    t1 = ttop[:, 0][:, None, None, :]
    t2 = ttop[:, 1][:, None, None, :]
    e1 = (t1 != ga4) & (t1 != gb4)
    e2 = (t2 != ga4) & (t2 != gb4)
    ex = torch.where(e1, vtop[:, 0][:, None, None, :],
                     torch.where(e2, vtop[:, 1][:, None, None, :],
                                 vtop[:, 2][:, None, None, :]))
    val = wsum(torch.maximum(ex, torch.maximum(la, lb)))
    feas = (admi[:, :, None] & admj[:, None, :]
            & (gai[:, :, None] != gaj[:, None, :]))
    return torch.where(feas, val, torch.full((), float("inf"),
                                             device=val.device))


def _row_best(val):
    return val.min(dim=-1).values, val.argmin(dim=-1).int()


def swap_best_dense(loads, cands, assign, valid):
    """Dense oracle: the full (N, N, W) post-swap tensor reduced to the
    per-row (best_val (N,), best_j (N,))."""
    (loads, cands, assign, valid), squeeze = _batched(
        loads, cands, assign, valid)
    lo, ga, adm, vtop, ttop = swap_prep(loads, cands, assign, valid)
    cands = cands.float()
    v, a = _row_best(_pair_vals(cands, lo, ga, adm, cands, lo, ga, adm,
                                vtop, ttop))
    return (v[0], a[0]) if squeeze else (v, a)


def swap_best_plain(loads, cands, assign, valid, *, tile_i: int = 128):
    """Plain PyTorch version of the kernel: the same reduction tiled over
    row blocks of ``tile_i`` (full j extent per block)."""
    (loads, cands, assign, valid), squeeze = _batched(
        loads, cands, assign, valid)
    lo, ga, adm, vtop, ttop = swap_prep(loads, cands, assign, valid)
    cands = cands.float()
    N = cands.shape[1]
    vals, args = [], []
    for i0 in range(0, N, max(1, tile_i)):
        s = slice(i0, i0 + tile_i)
        v, a = _row_best(_pair_vals(cands[:, s], lo[:, s], ga[:, s],
                                    adm[:, s], cands, lo, ga, adm,
                                    vtop, ttop))
        vals.append(v)
        args.append(a)
    v, a = torch.cat(vals, 1), torch.cat(args, 1)
    return (v[0], a[0]) if squeeze else (v, a)


def _lib():
    from .build import load
    lib = load("bfio_swap.cu")
    fn = lib.swap_best_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        lib.swap_best_max_w.argtypes = [ctypes.c_int]
        lib.swap_best_max_w.restype = ctypes.c_int
    return lib


def swap_best(loads, cands, assign, valid):
    """The kernel wrapper.  loads (G, W) / cands (N, W) float32, assign
    (N,) int32 or int64 (-1 = not admitted), valid (N,) bool — each
    optionally with a leading cluster axis C.  Returns (best_val f32,
    best_j i32) of shape (N,) or (C, N)."""
    if loads.device.type == "cpu":
        return swap_best_plain(loads, cands, assign, valid)
    if loads.device.type != "cuda":
        raise ValueError(f"swap_best: unsupported device {loads.device}")
    (loads, cands, assign, valid), squeeze = _batched(
        loads, cands, assign, valid)
    for name, x in (("cands", cands), ("assign", assign), ("valid", valid)):
        if x.device != loads.device:
            raise ValueError(f"swap_best: {name} is on {x.device}, loads "
                             f"on {loads.device}")
    C, G, W = loads.shape
    N = cands.shape[1]
    if cands.shape != (C, N, W) or assign.shape != (C, N) \
            or valid.shape != (C, N):
        raise ValueError(
            f"swap_best: shapes loads {tuple(loads.shape)}, cands "
            f"{tuple(cands.shape)}, assign {tuple(assign.shape)}, valid "
            f"{tuple(valid.shape)} do not agree")
    if cands.dtype != torch.float32 or valid.dtype != torch.bool \
            or assign.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"swap_best kernel takes float32 cands, int assign "
                        f"and bool valid, got {cands.dtype}, "
                        f"{assign.dtype}, {valid.dtype}")
    # one launch: the solver's tensors are float32 and contiguous, so no
    # op runs before the kernel; other loads are converted and strided
    # inputs copied
    lib = _lib()
    max_w = lib.swap_best_max_w(G)
    if W > max_w:
        raise ValueError(f"swap_best kernel: window W={W} exceeds the "
                         f"{max_w} its shared memory holds at G={G}")
    if loads.dtype != torch.float32:
        loads = loads.float()
    loads, cands, assign, valid = (x.contiguous()
                                   for x in (loads, cands, assign, valid))
    best_val = torch.empty((C, N), dtype=torch.float32, device=cands.device)
    best_j = torch.empty((C, N), dtype=torch.int32, device=cands.device)
    if C and N:
        rc = lib.swap_best_launch(
            C, N, G, W, int(assign.dtype == torch.int64),
            loads.data_ptr(), cands.data_ptr(), assign.data_ptr(),
            valid.data_ptr(), best_val.data_ptr(), best_j.data_ptr(),
            torch.cuda.current_stream(cands.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"swap_best kernel launch failed: CUDA error "
                               f"{rc}")
        swap_best.launches += 1
    return (best_val[0], best_j[0]) if squeeze else (best_val, best_j)


swap_best.launches = 0
