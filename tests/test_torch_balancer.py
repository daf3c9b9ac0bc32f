"""The port's BF-IO swap search and batched balancer
(repro_torch.kernels.bfio_swap, repro_torch.core.balancer_jax) against the
reference's (repro.kernels.bfio_swap, repro.kernels.ref,
repro.core.balancer_jax) on the same numpy-seeded inputs.

Everything here is held bit for bit, with no tolerance: one ulp in a swap
score can flip an argmin and then the assignment.  The port's plain tiled
version and dense oracle equal ``swap_best_xla`` / ``bfio_swap_best_ref``
on the reference's kernel fixtures (``tests/test_bfio_swap.py``); every
port method (``kernel``, which is the plain version on the CPU, ``plain``
and ``dense``) gives the reference's assignment on its solver trials,
pruned and unpruned; the batched solve at C > 1, including the pod
router's padding rows, equals the reference's vmapped solve.
"""
import functools
import warnings

warnings.filterwarnings("ignore")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.balancer_jax import bfio_assign as ref_assign
from repro.core.balancer_jax import bfio_assign_batch as ref_assign_batch
from repro.core.balancer_jax import windowed_imbalance as ref_imbalance
from repro.kernels.bfio_swap import swap_best_xla
from repro.kernels.ref import bfio_swap_best_ref
from repro_torch.core.balancer_jax import (
    bfio_assign,
    bfio_assign_batch,
    windowed_imbalance,
)
from repro_torch.kernels import bfio_swap as bs

# the reference's kernel fixtures: (G, N, W, tile)
SWAP_FIXTURES = [(2, 5, 1, 4), (4, 33, 3, 8), (8, 64, 9, 16), (3, 17, 2, 32)]
# port method -> the reference method it mirrors
METHODS = {"kernel": "xla", "plain": "xla", "dense": "dense"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny tensors: faster alone,
    and the suite runs in several worker processes on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _swap_inputs(G, N, W):
    rng = np.random.default_rng(G * 1000 + N)
    return (rng.uniform(0, 10, (G, W)).astype(np.float32),
            rng.uniform(0, 5, (N, W)).astype(np.float32),
            rng.integers(-1, G, N).astype(np.int32),
            rng.random(N) > 0.1)


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("G,N,W,tile", SWAP_FIXTURES)
def test_swap_search_bit_identical(G, N, W, tile):
    arrs = _swap_inputs(G, N, W)
    vd, ad = (np.asarray(x) for x in bfio_swap_best_ref(*_jax(*arrs)))
    vx, ax = (np.asarray(x) for x in swap_best_xla(*_jax(*arrs),
                                                   tile_i=tile))
    fin = np.isfinite(vd)
    for v, a in (bs.swap_best_plain(*_torch(*arrs), tile_i=tile),
                 bs.swap_best_dense(*_torch(*arrs)),
                 bs.swap_best(*_torch(*arrs))):
        v, a = v.numpy(), a.numpy()
        np.testing.assert_array_equal(v, vd)
        np.testing.assert_array_equal(v, vx)
        np.testing.assert_array_equal(a[fin], ad[fin])
        np.testing.assert_array_equal(a[fin], ax[fin])


def test_swap_prep_matches_reference():
    from repro.kernels.bfio_swap import swap_prep as ref_prep
    for G, N, W, _ in SWAP_FIXTURES:
        arrs = _swap_inputs(G, N, W)
        arrs[0][1] = arrs[0][0]           # ties in the top-3 ranking
        for want, got in zip(ref_prep(*_jax(*arrs)),
                             bs.swap_prep(*_torch(*arrs))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _instance(rng, G, N, W):
    return (rng.uniform(0, 10, (G, W)), rng.integers(0, 4, G),
            rng.uniform(0.5, 5, (N, W)))


def _trial(trial):
    """The reference's solver trials (tests/test_bfio_swap.py)."""
    rng = np.random.default_rng(500 + trial)
    G = int(rng.integers(2, 6))
    N = int(rng.integers(2, 30))
    W = int(rng.integers(1, 5))
    base, caps, cands = _instance(rng, G, N, W)
    U = min(N, int(caps.sum()))
    return (base.astype(np.float32), caps.astype(np.int32),
            cands.astype(np.float32), np.ones(N, bool), np.int32(U))


@functools.lru_cache(maxsize=None)
def _ref_trial(trial, method, prune_k):
    """The reference's assignment, once per reference configuration."""
    return np.asarray(ref_assign(*_jax(*_trial(trial)), method=method,
                                 tile=8, prune_k=prune_k))


@pytest.mark.parametrize("prune_k", [None, 16])
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("trial", range(6))
def test_assignment_matches_reference(trial, method, prune_k):
    arrs = _trial(trial)
    want = _ref_trial(trial, METHODS[method], prune_k)
    got = bfio_assign(*_torch(*arrs), method=method, tile=8,
                      prune_k=prune_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pruned_large_instance_matches_reference():
    """The reference's pruning instance, held against the reference run
    op by op.  Under one jit over the whole solve XLA fuses the W-sum in
    another order: at prune_k=4 its second swap iteration then scores a
    swap-back one ulp below the current objective (the 1e-6 margin is
    below half an ulp at 64.0) and takes it, where its own op-by-op run
    and the port do not."""
    rng = np.random.default_rng(77)
    base, caps, cands = _instance(rng, 8, 64, 4)
    arrs = (base.astype(np.float32), caps.astype(np.int32),
            cands.astype(np.float32), np.ones(64, bool),
            np.int32(min(64, caps.sum())))
    with jax.disable_jit():
        want = np.asarray(ref_assign(*_jax(*arrs), prune_k=4))
    got = bfio_assign(*_torch(*arrs), prune_k=4)
    np.testing.assert_array_equal(got.numpy(), want)


def _batch_packed():
    """The reference's batch fixture: C=4 fully-packed clusters."""
    rng = np.random.default_rng(31)
    C, G, W = 4, 3, 2
    items = []
    for _ in range(C):
        caps = rng.integers(1, 3, G)
        base = rng.uniform(0, 10, (G, W))
        cands = rng.uniform(0.5, 5, (int(caps.sum()), W))
        items.append((base, caps, cands))
    n_max = max(c.shape[0] for _, _, c in items)
    cands_b = np.zeros((C, n_max, W), np.float32)
    valid_b = np.zeros((C, n_max), bool)
    for c, (_, _, cn) in enumerate(items):
        cands_b[c, :cn.shape[0]] = cn
        valid_b[c, :cn.shape[0]] = True
    return (np.stack([b for b, _, _ in items]).astype(np.float32),
            np.stack([k for _, k, _ in items]).astype(np.int32),
            cands_b, valid_b,
            np.array([c.shape[0] for _, _, c in items], np.int32))


def _batch_pods():
    """The pod router's shape: pods of unequal size padded with zero-cap
    rows of load 1e30, integer sizes, ragged candidate counts."""
    rng = np.random.default_rng(9)
    P, rmax, npad, W = 3, 4, 16, 3
    base = np.full((P, rmax, W), 1e30)
    caps = np.zeros((P, rmax), np.int32)
    cands = np.zeros((P, npad, W))
    valid = np.zeros((P, npad), bool)
    per = np.array([11, 16, 5])
    for p, m in enumerate((4, 3, 4)):
        base[p, :m] = rng.integers(0, 900, (m, 1)) + np.arange(W) * 3.0
        caps[p, :m] = npad
        cands[p, :per[p]] = rng.integers(2, 200, (per[p], 1)) + np.arange(W)
        valid[p, :per[p]] = True
    return (base.astype(np.float32), caps, cands.astype(np.float32), valid,
            per.astype(np.int32))


def _batch_random():
    rng = np.random.default_rng(41)
    C, G, N, W = 5, 6, 40, 3
    return (rng.uniform(0, 10, (C, G, W)).astype(np.float32),
            rng.integers(0, 9, (C, G)).astype(np.int32),
            rng.uniform(0.5, 5, (C, N, W)).astype(np.float32),
            rng.random((C, N)) > 0.25,
            rng.integers(0, 41, C).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _ref_batch(batch, method, prune_k):
    return np.asarray(ref_assign_batch(*_jax(*batch()), swap_iters=16,
                                       method=method, prune_k=prune_k))


@pytest.mark.parametrize("prune_k", [None, 12])
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("batch", [_batch_packed, _batch_pods,
                                   _batch_random])
def test_batch_matches_reference(batch, method, prune_k):
    arrs = batch()
    want = _ref_batch(batch, METHODS[method], prune_k)
    got = bfio_assign_batch(*_torch(*arrs), swap_iters=16, method=method,
                            prune_k=prune_k)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    for c in range(arrs[0].shape[0]):      # batch == per-cluster solves
        one = bfio_assign(*(a[c] for a in _torch(*arrs)), swap_iters=16,
                          method=method, prune_k=prune_k)
        np.testing.assert_array_equal(one.numpy(), want[c])


def test_windowed_imbalance_equal():
    """Random floats where XLA's CPU reduction over G and W is the left
    fold (G <= 32); integer-valued loads, as the fleet router's are, at
    larger G, where every summation order is exact."""
    rng = np.random.default_rng(3)
    cases = [rng.uniform(0, 100, s) for s in ((1, 1), (2, 3), (5, 9),
                                              (16, 8), (32, 4))]
    cases += [rng.integers(0, 5000, s) for s in ((64, 4), (256, 3))]
    for loads in cases:
        loads = loads.astype(np.float32)
        want = np.asarray(ref_imbalance(jnp.asarray(loads)))
        got = windowed_imbalance(torch.from_numpy(loads))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        bfio_assign(*_torch(*_trial(0)), method="xla")
