"""The port's device-side routed serving loop (repro_torch.serving.
device_loop) against the reference's jitted loop on the same inputs.

On the CPU the port's BF-IO admission runs the swap search's plain
version, and every float sum follows the reference's order, so every
``LoopState`` field is held equal with ``==`` (dtype and shape included)
on the reference's own fixtures (tests/test_device_loop.py: seeds 1-4,
the chunked-prefill budget; tests/test_preemption.py: the pooled loop
with LIFO evictions and the loop without a pool), at the fixtures' step
counts and after single steps.  Integer-valued cases at G=32 and G=40
(sums over 128 and 160 slots, imbalance sums over more than 32 workers)
are equal too.  The reference tests' own invariants are kept: capacity,
completion and the budget bound.
"""
import warnings

warnings.filterwarnings("ignore")

import numpy as np
import pytest

from repro.serving.device_loop import init_loop_state as jax_init_loop_state
from repro.serving.device_loop import \
    make_device_serving_loop as jax_make_device_serving_loop
from repro_torch.serving import (
    LoopState,
    init_loop_state,
    make_device_serving_loop,
)


def _demo(seed):
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.uniform(90, 100, 16), rng.uniform(1, 10, 48)])
    return sizes, np.full(len(sizes), 6)


def _fixture(name):
    """(G, B, wait_cap, sizes, remaining, loop kwargs) of each fixture."""
    if name == "complete":                # test_all_requests_complete
        rng = np.random.default_rng(1)
        return 4, 4, 64, rng.uniform(5, 50, 40), rng.integers(2, 10, 40), {}
    if name == "capacity":                # test_capacity_never_exceeded
        rng = np.random.default_rng(2)
        return 3, 2, 32, rng.uniform(1, 9, 30), rng.integers(1, 6, 30), {}
    if name == "balance":                 # test_balances_better_than_unrouted
        rng = np.random.default_rng(3)
        sizes = np.concatenate([rng.uniform(90, 100, 16),
                                rng.uniform(1, 10, 48)])
        return 4, 8, 128, sizes, np.full(len(sizes), 6), {}
    if name == "chunked":                 # the prefill budget
        rng = np.random.default_rng(4)
        return (4, 4, 64, rng.uniform(20, 50, 40), rng.integers(2, 10, 40),
                dict(prefill_budget=16.0))
    if name == "pooled":                  # TestDeviceLoopPool
        rng = np.random.default_rng(1)
        return (4, 4, 64, rng.uniform(5, 50, 40), rng.integers(2, 10, 40),
                dict(kv_pool=150.0))
    if name in ("int_g32", "int_g40"):    # integer-valued, wide G
        G = 32 if name == "int_g32" else 40
        rng = np.random.default_rng(G)
        n = 8 * G
        sizes = np.concatenate([rng.integers(200, 301, n // 8),
                                rng.integers(5, 31, n - n // 8)])
        return G, 4, n, sizes.astype(np.float64), rng.integers(4, 24, n), {}
    raise KeyError(name)


# (fixture, steps): the reference tests' step counts, plus single steps
CASES = [("complete", 80), ("capacity", 20), ("capacity", 80),
         ("balance", 24), ("chunked", 1), ("chunked", 400), ("pooled", 1),
         ("pooled", 400), ("int_g32", 12), ("int_g40", 8)]


def _both(name, steps):
    G, B, W, sizes, rem, kw = _fixture(name)
    want = jax_make_device_serving_loop(G, B, W, **kw)(
        jax_init_loop_state(G, B, sizes, rem, W), steps)
    got = make_device_serving_loop(G, B, W, device="cpu", **kw)(
        init_loop_state(G, B, sizes, rem, W, device="cpu"), steps)
    return want, got


@pytest.mark.parametrize("name,steps", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_loop_state_equals_reference(name, steps):
    want, got = _both(name, steps)
    assert isinstance(got, LoopState)
    assert got._fields == want._fields
    for field in want._fields:
        a, b = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, field
        assert np.array_equal(a, b), f"{field} differs after {steps} steps"
    assert int(got.tot_steps) == steps
    if name == "pooled" and steps > 1:
        assert int(got.tot_preempts) > 0


def test_completion_and_capacity():
    """The reference's invariants on the port: no worker ever holds more
    than B active slots, and every request completes."""
    G, B, W, sizes, rem, _ = _fixture("capacity")
    run = make_device_serving_loop(G, B, W, device="cpu")
    state = init_loop_state(G, B, sizes, rem, W, device="cpu")
    worker = np.repeat(np.arange(G), B)
    for _ in range(40):
        state = run(state, 1)
        act = state.slot_active.numpy()
        assert np.bincount(worker[act], minlength=G).max() <= B
    assert int(state.slot_active.sum()) == 0
    assert int((state.wait_prefill > 0).sum()) == 0
    assert int(state.tot_preempts) == 0


def test_budget_bound_and_drain():
    """One chunked step absorbs at most the budget; the run drains."""
    G, B, W, sizes, rem, kw = _fixture("chunked")
    run = make_device_serving_loop(G, B, W, device="cpu", **kw)
    state = init_loop_state(G, B, sizes, rem, W, device="cpu")
    s1 = run(state, 1)
    assert float(s1.slot_load[s1.slot_active].sum()) <= 16.0 + 1e-6
    assert float(s1.slot_prefill_left.sum()) > 0
    end = run(state, 400)
    assert int(end.slot_active.sum()) == 0
    assert int((end.wait_prefill > 0).sum()) == 0
    assert float(end.slot_prefill_left.sum()) == 0.0


def test_routed_beats_fill_in_order():
    """BF-IO routing beats filling the slots in arrival order."""
    G, B, W, sizes, rem, _ = _fixture("balance")
    st = make_device_serving_loop(G, B, W, device="cpu")(
        init_loop_state(G, B, sizes, rem, W, device="cpu"), 24)
    loads = np.zeros(G)
    for i, size in enumerate(sizes[:G * B]):
        loads[i // B] += size
    assert float(st.tot_imbalance) / 24 < G * loads.max() - loads.sum()


def test_device_defaults_to_cuda_and_checks_the_state():
    """Without ``device`` both entry points run on ``cuda`` (and raise on
    a box without a card); a state on another device is refused."""
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_device_serving_loop(2, 2, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_loop_state(2, 2, [1.0], [1], 8)
    run = make_device_serving_loop(2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="lives on cpu"):
        run(init_loop_state(2, 2, [1.0], [1], 8, device="cpu"), 1)
    with pytest.raises(ValueError, match="do not fit"):
        init_loop_state(2, 2, np.ones(9), np.ones(9), 8, device="cpu")
