"""The port's serving engine (repro_torch.serving) against the reference
engine (repro.serving) on the same request stream.

Scheduling never reads logits except through emitted tokens, and the
tiny dense model runs in float32 on the CPU on bridged weights, so the
reference's exactness carries over: the whole ``stats()`` dict equal with
``==`` (the engine's time and energy are modelled, identically), every
request's generation and worker equal, and the resident-KV peak equal —
under four routing policies, synchronous and chunked prefill, a
half-sized pool under swap and recompute preemption, and the prefix
cache.  The host-side modules (the IO solver, the block allocator, the
prefix index) are held to the same operation sequences.
"""
import warnings

warnings.filterwarnings("ignore")

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import io_solver as jax_io_solver
from repro.core import make_policy as jax_make_policy
from repro.launch.mesh import make_cpu_mesh
from repro.models import init_params as jax_init_params
from repro.models import split_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.paged_cache import BlockAllocator as JaxBlockAllocator
from repro.serving.paged_cache import PrefixIndex as JaxPrefixIndex
from repro_torch.configs.base import ModelConfig
from repro_torch.core import io_solver
from repro_torch.core import make_policy
from repro_torch.models import params_from_numpy
from repro_torch.serving import (
    BlockAllocator,
    EngineConfig,
    PrefixIndex,
    ServeRequest,
    ServingEngine,
    make_cache_backend,
)
from repro_torch.serving.preemption import swap_in_blocks, swap_out_blocks

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
CFG = ModelConfig(**TINY)
G, B, MAX_SEQ = 2, 4, 64
POLICIES = ["fcfs", "jsq", "bfio_h0", "bfio_h8"]
MODES = {
    "sync": {},
    "chunked": dict(prefill_chunk=8),
    "swap": dict(paged_pool_blocks=16, preemption_mode="swap"),
    "recompute": dict(paged_pool_blocks=16, preemption_mode="recompute"),
    "prefix": dict(prefix_cache=True),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(**TINY)
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams, make_cpu_mesh()


def _requests(cls, mode, n=14, seed=3):
    """The reference's stream (tests/test_cache_backend.py), with longer
    decodes under memory pressure and shared prompt prefixes for the
    prefix cache."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 128, size=20) for _ in range(3)]
    out = []
    for i in range(n):
        toks = rng.integers(1, 128, size=int(rng.integers(4, 30)))
        if mode == "prefix":
            toks = np.concatenate([heads[i % 3], toks[:int(rng.integers(1, 9))]])
        max_new = int(rng.integers(12, 30) if mode in ("swap", "recompute")
                      else rng.integers(3, 10))
        out.append(cls(rid=i, tokens=toks, max_new_tokens=max_new))
    return out


def _run_both(weights, policy, mode, drive=None):
    jcfg, jparams, tparams, mesh = weights
    kw = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              cache_backend="paged", **MODES[mode])
    je = JaxServingEngine(jcfg, jparams, JaxEngineConfig(**kw),
                          jax_make_policy(policy), mesh=mesh)
    te = ServingEngine(CFG, tparams, EngineConfig(**kw), make_policy(policy),
                       device="cpu")
    jr, tr = _requests(JaxServeRequest, mode), _requests(ServeRequest, mode)
    for e, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            e.submit(r)
    if drive is not None:
        return je, te, jr, tr, drive(je), drive(te)
    return je, te, jr, tr, je.run(), te.run()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_reference(weights, policy, mode):
    je, te, jr, tr, js, ts = _run_both(weights, policy, mode)
    assert ts == js
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, f"request {a.rid} diverged"
        assert (b.worker, b.status, b.t_finish) == (a.worker, a.status,
                                                   a.t_finish)
    assert te.kv_peak_bytes == je.kv_peak_bytes
    if mode in ("swap", "recompute"):
        assert ts["preemptions"] > 0
    if mode == "prefix":
        assert ts["prefix_hits"] > 0


@pytest.mark.parametrize("mode", ["sync", "swap"])
def test_drain_and_load_snapshot_match(weights, mode):
    def drive(eng):
        for _ in range(4):
            eng.step()
        snap = dataclasses.asdict(eng.load_snapshot())
        handoff = [(r.rid, r.status, list(r.generated),
                    None if r.preempted is None else r.preempted.length)
                   for r in eng.drain()]
        return snap, handoff, dataclasses.asdict(eng.load_snapshot())
    _, _, _, _, jout, tout = _run_both(weights, "bfio_h8", mode, drive)
    assert tout == jout


def test_swap_copies_round_trip():
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(
        rng.normal(size=(2, 40, 4, 2, 8)).astype(np.float32))
    blocks = rng.permutation(40)[:35]
    host = swap_out_blocks(pool, blocks, tile=8)
    assert host.shape == (2, 35, 4, 2, 8) and host.device.type == "cpu"
    fresh = torch.zeros_like(pool)
    dst = rng.permutation(40)[:35]
    swap_in_blocks(fresh, dst, host, tile=8)
    assert torch.equal(fresh[:, dst], pool[:, blocks])


def _io_instances():
    rng = np.random.default_rng(0)
    out = [(np.zeros((2, 1)), np.array([2, 2]),
            np.array([[4.0], [3.0], [2.0], [1.0]])),
           (np.zeros((3, 1)), np.array([1, 1, 1]), np.zeros((0, 1))),
           (np.zeros((2, 1)), np.array([0, 0]), np.ones((4, 1)))]
    for _ in range(60):
        g, n, w = (int(rng.integers(2, 5)), int(rng.integers(1, 9)),
                   int(rng.integers(1, 4)))
        out.append((rng.uniform(0, 10, size=(g, w)),
                    rng.integers(0, 4, size=g),
                    rng.uniform(0, 5, size=(n, w))))
    return out


def test_io_solver_assignments_equal():
    for base, caps, cands in _io_instances():
        for fn in ("solve_io", "solve_greedy"):
            np.testing.assert_array_equal(
                getattr(io_solver, fn)(base, caps, cands),
                getattr(jax_io_solver, fn)(base, caps, cands))
        if cands.shape[0] <= 6:
            ta, tv = io_solver.solve_exact(base, caps, cands)
            ja, jv = jax_io_solver.solve_exact(base, caps, cands)
            np.testing.assert_array_equal(ta, ja)
            assert tv == jv


@pytest.mark.parametrize("evict", ["lru", "admission"])
def test_allocator_and_prefix_index_sequences_equal(evict):
    """One operation sequence (alloc, share, free into the cached list,
    reclaim) on both packages' allocators with a prefix index attached."""
    states = []
    for Alloc, Index in ((JaxBlockAllocator, JaxPrefixIndex),
                         (BlockAllocator, PrefixIndex)):
        a, idx = Alloc(10, evict=evict), Index()
        a.prefix = idx
        rng = np.random.default_rng(1)
        log = []
        held: dict = {}
        for step in range(60):
            op = int(rng.integers(0, 4))
            toks = rng.integers(1, 5, size=int(rng.integers(1, 9)))
            if op <= 1 and a.n_reclaimable >= 2:
                keys = idx.keys_for(toks, 4)
                hit = [idx.lookup(*k) for k in keys]
                blocks = a.alloc(len(keys))
                for (key, parent, span), b in zip(keys, blocks):
                    idx.register(key, parent, span, b)
                idx.note_lookup(len(keys), sum(h is not None for h in hit))
                held[step] = blocks
            elif op == 2 and held:
                k = sorted(held)[int(rng.integers(0, len(held)))]
                released = a.free(held.pop(k))
                idx.evict(released)
                log.append(("freed", tuple(released)))
            elif op == 3 and held:
                k = sorted(held)[0]
                b = held[k][0]
                a.add_ref(b)
                held[-step - 1] = [b]
            log.append((a.n_free, a.n_cached, tuple(a._refs.tolist()),
                        len(idx), idx.hits, idx.queries))
        states.append((log, a.blocks_reclaimed, a.blocks_revived))
    assert states[1] == states[0]


def test_unported_paths_raise(weights):
    """Every family is ported: a vlm slot backend builds (vlm's engine
    parity is in tests/test_torch_vlm.py).  The per-slot
    ``engine_mode="ref"`` is ported (tests/test_torch_engine_ref.py) and,
    as in the reference, refuses the paged backend with a
    ``ValueError``."""
    _, _, tparams, _ = weights
    vlm = ModelConfig(**dict(TINY, name="tiny-vlm", family="vlm",
                             patch_tokens=4))
    be = make_cache_backend("slot", vlm, tparams,
                            EngineConfig(cache_backend="slot"), "cpu")
    assert be.name == "slot"
    assert tuple(be.cache["blocks"]["k"].shape[:2]) == (
        vlm.n_layers, be.N)
    with pytest.raises(ValueError, match="seed oracle"):
        ServingEngine(CFG, tparams, EngineConfig(engine_mode="ref",
                                                 cache_backend="paged"),
                      make_policy("fcfs"), device="cpu")


def test_paged_cache_writes_match_reference():
    """PagedKVCache's per-slot writes (prompt scatter, token append with
    a block crossing) land where the reference's land."""
    import jax.numpy as jnp
    from repro.serving.paged_cache import PagedKVCache as JaxPagedKVCache
    from repro_torch.serving import PagedKVCache

    rng = np.random.default_rng(2)
    kw = dict(n_layers=2, n_blocks=9, block_size=4, n_kv_heads=2,
              head_dim=8, max_requests=3, max_blocks_per_req=4)
    jc = JaxPagedKVCache.create(dtype=jnp.float32, **kw)
    tc = PagedKVCache.create(dtype=torch.float32, device="cpu", **kw)
    prompt = rng.normal(size=(2, 7, 2, 8)).astype(np.float32)
    toks = rng.normal(size=(2, 2, 2, 8)).astype(np.float32)
    for c, arr in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        c.allocator.alloc(2)                 # offset the slot's blocks
        c.admit(1, 7)
        for layer in range(2):
            c.write_prompt(layer, 1, arr(prompt[layer]), arr(prompt[layer]))
        for t in range(2):                   # positions 7 and 8 (crossing)
            c.append_token(1)
            for layer in range(2):
                c.write_token(layer, 1, arr(toks[layer, t]),
                              arr(-toks[layer, t]))
    np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
    np.testing.assert_array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(tc.v_pool.numpy(), np.asarray(jc.v_pool))
    assert tc.resident_bytes() == jc.resident_bytes()


def test_paged_cache_create_requires_device():
    """The pool is built where the caller says: no CPU default that a
    card's engine could silently fall back to."""
    from repro_torch.serving import PagedKVCache

    kw = dict(n_layers=1, n_blocks=4, block_size=4, n_kv_heads=1,
              head_dim=8, max_requests=2, max_blocks_per_req=2)
    with pytest.raises(TypeError, match="device"):
        PagedKVCache.create(**kw)
    pool = PagedKVCache.create(device="cpu", **kw)
    assert pool.k_pool.device.type == "cpu"
