"""The bodies of the port's captured regions (``repro_torch.core.graphs``):
the decode step per (backend, bucket), the batched BF-IO solve per padded
shape and the device loop's step.

On the CPU nothing is captured: each body runs op by op, and here it runs
under :class:`HostSyncGuard`, a dispatch mode that fails on any op that
reads a value back to the host or whose output shape depends on the data
(``nonzero``, ``.item()`` / ``bool()``, ``masked_select``, boolean-mask
indexing) or makes a tensor from host data inside the body (``torch.
tensor``: a copy from pageable host memory on the card), none of which a
CUDA graph can hold.  With the reference's
bridged float32 weights, each body is held against the reference:

* the slot and paged decode for one smoke config of every family (paged:
  the attention families), at every bucket of ``_decode_buckets``, with
  padding rows: next tokens and ``lengths`` equal, every cache or pool
  entry the reference leaves untouched bit for bit as it was, the
  written entries within the model tests' 1e-4 (XLA's and PyTorch's CPU
  matrix products round differently by ~1e-6, so new KV and states cannot
  be equal bit for bit), the paged allocator's tables equal;
* the fixed-shape writes that replace the dropped scatters: the paged
  decode's pad rows, frozen KV (``blk == n_blocks``) and a step where no
  row writes, against JAX's dropping ``.at[].set``; the slot backend's
  pad rows (``dst == N``) against the reference's ``scatter_rows``; all
  bit for bit;
* ``bfio_assign_batch`` at the fleet routers' padded shapes and one
  device-loop step with ``kv_pool == 0`` (and with a prefill budget):
  assignments and every ``LoopState`` field with ``==``.

The ``cuda`` cases compare capture with ``graphs.eager()`` on the card
(stats, generations, launch counts, ``LoopState``) and skip here.  The
reference is imported inside fixtures, so the card cases run where JAX is
not installed.
"""
import contextlib
import dataclasses
import warnings

warnings.filterwarnings("ignore")

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.core import graphs
from repro_torch.core.balancer_jax import bfio_assign_batch
from repro_torch.fleet.router import _pad_bucket
from repro_torch.models import init_params, paged_decode_fn, params_from_numpy
from repro_torch.models.transformer import _kept_writes
from repro_torch.serving import (
    EngineConfig,
    init_loop_state,
    make_device_serving_loop,
)
from repro_torch.serving.cache_backend import make_cache_backend, scatter_rows
from repro_torch.serving.engine import _decode_buckets

aten = torch.ops.aten
# lift_fresh: a tensor made from host data (``torch.tensor(x)``), which on
# the card is a copy from pageable host memory that a capture refuses
_FORBIDDEN = (aten.nonzero, aten._local_scalar_dense, aten.masked_select,
              aten.lift_fresh)
_INDEXING = (aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_)


class HostSyncGuard(TorchDispatchMode):
    """Fails on every op a CUDA graph cannot hold: a host read or an
    output shape that depends on the data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _FORBIDDEN:
            raise AssertionError(f"{func}: a host read or a host-made "
                                 f"tensor inside a captured body")
        if func.overloadpacket in _INDEXING and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            raise AssertionError(f"{func} with a boolean mask: its shape "
                                 f"depends on the data")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def guarded_bodies():
    """Every region's body run through ``Graphs.run`` under the guard: the
    host arrays are staged onto the device first, outside the body, as a
    captured call copies them into its static buffers."""
    run = graphs.Graphs.run

    def guarded(self, key, body, args, state=tuple, repeat=1):
        inputs = [self._on_device(a) for a in args]
        with HostSyncGuard():
            return run(self, key, body, inputs, state, repeat)
    graphs.Graphs.run = guarded
    try:
        yield
    finally:
        graphs.Graphs.run = run


ARCHS = {"dense": "granite-8b", "moe": "qwen3-moe-30b-a3b",
         "ssm": "xlstm-350m", "hybrid": "zamba2-1.2b",
         "vlm": "llava-next-mistral-7b", "audio": "whisper-tiny"}
PAGED = ("dense", "moe", "vlm")
G, B, MAX_SEQ, BS, PROMPT = 2, 4, 64, 16, 32
N = G * B
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref():
    """The reference package (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.balancer_jax import bfio_assign_batch as assign_batch
    from repro.launch.mesh import make_cpu_mesh
    from repro.models import init_cache
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving.cache_backend import \
        make_cache_backend as jax_make_backend
    from repro.serving.cache_backend import scatter_rows as jax_scatter
    from repro.serving.device_loop import init_loop_state as jax_init_loop
    from repro.serving.device_loop import \
        make_device_serving_loop as jax_make_loop
    return dict(jax=jax, jnp=jnp, smoke=jax_smoke_config,
                assign_batch=assign_batch, mesh=make_cpu_mesh(),
                init_cache=init_cache, EngineConfig=JaxEngineConfig,
                make_backend=jax_make_backend, scatter_rows=jax_scatter,
                init_loop=jax_init_loop, make_loop=jax_make_loop)


@pytest.fixture(scope="module")
def models(ref):
    """(reference cfg, port cfg, reference params, port params) by
    family, float32: the port's seeded init handed to both packages as
    numpy arrays (the two keep the same tree; the port's init is far
    quicker on the CPU than the reference's)."""
    jax, jnp = ref["jax"], ref["jnp"]
    out = {}
    for fam, arch in ARCHS.items():
        jcfg = dataclasses.replace(ref["smoke"](arch), dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tree = jax.tree.map(lambda t: t.numpy(),
                            init_params(tcfg, 0, device="cpu"))
        out[fam] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                    params_from_numpy(tree, device="cpu"))
    return out


def _filled(tree, rng, cfg, name=""):
    """A prefill cache's layout filled with seeded values: lengths 3..32,
    encoder lengths 1..encoder_seq, every float entry in [0.5, 1.5)."""
    if isinstance(tree, dict):
        return {k: _filled(v, rng, cfg, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_filled(v, rng, cfg, name) for v in tree)
    a = np.asarray(tree)
    if name == "lengths":
        return rng.integers(3, PROMPT + 1, a.shape).astype(a.dtype)
    if name == "enc_lengths":
        return rng.integers(1, cfg.encoder_seq + 1, a.shape).astype(a.dtype)
    return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)


def _np_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _np_leaves(v)]
    return [np.array(tree)]


def _snapshot(backend) -> list:
    if backend.name == "paged":
        return [np.array(backend.kv.k_pool), np.array(backend.kv.v_pool)]
    return _np_leaves(backend.cache)


def _assert_step(want0, want1, got0, got1, what):
    """The port's leaves ``got1`` after a step against the reference's
    ``want1``: exact leaves equal; entries the reference left untouched
    unchanged bit for bit; the written ones within TOL."""
    for w0, w1, g0, g1 in zip(want0, want1, got0, got1):
        assert g1.shape == w1.shape and g1.dtype == w1.dtype, what
        if not np.issubdtype(w1.dtype, np.floating):
            np.testing.assert_array_equal(g1, w1, err_msg=what)
            continue
        kept = w1 == w0
        assert np.array_equal(g1[kept], g0[kept]), \
            f"{what}: the port wrote where the reference did not"
        np.testing.assert_allclose(g1, w1, err_msg=what, **TOL)


def _backends(ref, models, fam, backend):
    jcfg, tcfg, jp, tp = models[fam]
    kw = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              cache_backend=backend, paged_block_size=BS)
    jb = ref["make_backend"](backend, jcfg, jp, ref["EngineConfig"](**kw),
                             ref["mesh"])
    tb = make_cache_backend(backend, tcfg, tp, EngineConfig(**kw), "cpu")
    if fam == "audio":
        # the reference's init_cache binds one array to both cross_kv
        # leaves, which its vec backend then donates twice: give each leaf
        # its own buffer (nothing else of the reference is touched)
        jb.cache = ref["jax"].tree.map(lambda a: ref["jnp"].array(a),
                                       jb.cache)
    rng = np.random.default_rng(7)
    mini = _filled(ref["jax"].tree.map(
        np.asarray, ref["init_cache"](jcfg, N, PROMPT)), rng, tcfg)
    src = np.arange(N)
    jb.write_prefill(ref["jax"].tree.map(ref["jnp"].asarray, mini), src,
                     src)
    tb.write_prefill(params_from_numpy(mini, device="cpu"), src, src)
    return jb, tb, tcfg


@pytest.mark.parametrize("backend,fam", [("slot", f) for f in ARCHS]
                         + [("paged", f) for f in PAGED])
def test_decode_body_matches_reference(ref, models, backend, fam):
    """Every bucket of ``_decode_buckets(N)``, each with padding rows (the
    slot backend's full bucket is its full-batch decode), twice, under
    the host-sync guard."""
    jb, tb, tcfg = _backends(ref, models, fam, backend)
    rng = np.random.default_rng(11)
    slot_tokens = rng.integers(1, tcfg.vocab_size, N).astype(np.int32)
    for _ in range(2):
        for bucket in _decode_buckets(N):
            act = np.sort(rng.choice(N, bucket - 1, replace=False))
            want0, got0 = _snapshot(jb), _snapshot(tb)
            jn = np.asarray(jb.decode(slot_tokens, act, bucket))
            with guarded_bodies():
                tn = tb.decode(slot_tokens, act, bucket)
            what = f"{fam} {backend} bucket {bucket}"
            np.testing.assert_array_equal(tn, jn, err_msg=what)
            _assert_step(want0, _snapshot(jb), got0, _snapshot(tb), what)
            if backend == "paged":
                np.testing.assert_array_equal(tb.kv.lengths, jb.kv.lengths)
                np.testing.assert_array_equal(tb.kv.block_tables,
                                              jb.kv.block_tables)
            slot_tokens[act] = tn


def _paged_inputs(tcfg, rng, n_pool, blk_rows):
    L, hkv, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.hd
    kp = rng.uniform(0.5, 1.5, (L, n_pool, BS, hkv, hd)).astype(np.float32)
    vp = rng.uniform(0.5, 1.5, kp.shape).astype(np.float32)
    mb = MAX_SEQ // BS
    tables = rng.permutation(n_pool)[:len(blk_rows) * mb].reshape(
        len(blk_rows), mb).astype(np.int32)
    lens = np.array([r[0] for r in blk_rows], np.int32)
    blk = np.array([n_pool if r[1] else tables[i, (r[0] - 1) // BS]
                    for i, r in enumerate(blk_rows)], np.int32)
    tables[lens == 0] = -1                      # padding rows
    off = ((np.maximum(lens, 1) - 1) % BS).astype(np.int32)
    toks = rng.integers(1, tcfg.vocab_size, len(blk_rows)).astype(np.int32)
    return kp, vp, tables, lens, blk, off, toks


# (length, dropped): a live row, frozen KV past max_seq_len, padding
@pytest.mark.parametrize("rows", [
    [(20, False), (MAX_SEQ + 3, True), (0, True), (7, False)],
    [(MAX_SEQ + 1, True), (0, True), (0, True)],          # no row writes
], ids=["pads-and-frozen", "none-live"])
def test_paged_dropped_writes_match_reference(ref, models, rows):
    """``paged_decode_fn`` with rows whose ``blk == n_blocks`` against the
    reference's (JAX drops those scatters): tokens equal, no entry the
    reference keeps changed; with no live row the pools come back bit for
    bit as they were."""
    jnp = ref["jnp"]
    from repro.models import paged_decode_fn as jax_paged_decode_fn
    jcfg, tcfg, jp, tp = models["dense"]
    rng = np.random.default_rng(5)
    kp, vp, tables, lens, blk, off, toks = _paged_inputs(tcfg, rng, 20, rows)
    jtok, jkp, jvp = jax_paged_decode_fn(
        jcfg, jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(np.minimum(lens, MAX_SEQ)), jnp.asarray(blk),
        jnp.asarray(off), jnp.asarray(toks), block_size=BS,
        attn_impl="gather", mesh=ref["mesh"])
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    inputs = [torch.from_numpy(a) for a in (
        tables, np.minimum(lens, MAX_SEQ), blk, off, toks)]
    with HostSyncGuard():
        ttok, _, _ = paged_decode_fn(tcfg, tp, tkp, tvp, *inputs,
                                     block_size=BS)
    real = lens > 0       # a padding row's token is garbage in both
    np.testing.assert_array_equal(ttok.numpy()[real], np.asarray(jtok)[real])
    _assert_step([kp, vp], [np.asarray(jkp), np.asarray(jvp)], [kp, vp],
                 [tkp.numpy(), tvp.numpy()], "paged dropped writes")
    if all(r[1] for r in rows):
        assert np.array_equal(tkp.numpy(), kp)
        assert np.array_equal(tvp.numpy(), vp)


@pytest.mark.parametrize("blk", [[3, 5, 6, 1, 6], [6, 6, 2, 6, 6],
                                 [6, 6, 6, 6, 6], [0, 0, 0, 0, 0]])
def test_kept_writes_match_jax_dropping_scatter(ref, blk):
    """The paged decode's write on its own, into a pool of 6 blocks: the
    values the reference's ``.at[blk, off].set`` leaves (``blk == 6``
    dropped), bit for bit.  The rows that write have distinct
    destinations, as an engine's rows do."""
    jnp = ref["jnp"]
    rng = np.random.default_rng(3)
    pool = rng.uniform(0.5, 1.5, (6, BS, 2, 8)).astype(np.float32)
    new = rng.uniform(2.0, 3.0, (len(blk), 2, 8)).astype(np.float32)
    blk = np.array(blk, np.int32)
    off = np.arange(len(blk), dtype=np.int32) * 3
    want = np.asarray(jnp.asarray(pool).at[jnp.asarray(blk),
                                           jnp.asarray(off)].set(new))
    got = torch.from_numpy(pool.copy())
    blk, off, new = (torch.from_numpy(a) for a in (blk, off, new))
    with HostSyncGuard():
        src, wblk, woff, keep = _kept_writes(blk, off, 6)
        got[wblk, woff] = torch.where(keep, new[src], got[0, 0])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dst", [[5, 8, 1, 8], [8, 2, 8, 8], [7, 0, 3, 6]])
def test_scatter_rows_pads_match_reference(ref, dst):
    """Slot pads (``dst == N``) dropped as the reference's scatter drops
    them, every leaf bit for bit, under the guard."""
    jnp, jax = ref["jnp"], ref["jax"]
    rng = np.random.default_rng(1)
    cache = {"lengths": rng.integers(0, 50, N).astype(np.int32),
             "blocks": {"k": rng.normal(size=(2, N, 6, 3)).astype(np.float32),
                        "s": (rng.normal(size=(2, N, 4)).astype(np.float32),
                              rng.normal(size=(2, N)).astype(np.float32))}}
    sub = {"lengths": rng.integers(0, 50, 4).astype(np.int32),
           "blocks": {"k": rng.normal(size=(2, 4, 6, 3)).astype(np.float32),
                      "s": (rng.normal(size=(2, 4, 4)).astype(np.float32),
                            rng.normal(size=(2, 4)).astype(np.float32))}}
    dst = np.array(dst, np.int64)
    want = ref["scatter_rows"](jax.tree.map(jnp.asarray, cache),
                               jax.tree.map(jnp.asarray, sub),
                               jnp.asarray(dst))
    got = params_from_numpy(cache, device="cpu")
    sub, dst = params_from_numpy(sub, device="cpu"), torch.from_numpy(dst)
    with HostSyncGuard():
        scatter_rows(got, sub, dst)
    for w, g in zip(_np_leaves(jax.tree.map(np.asarray, want)),
                    _np_leaves(got)):
        assert np.array_equal(g, w)


def _router_inputs(n, R, W, pods=1, seed=0):
    """The fleet routers' padded solve: ``BFIORouter.route`` (pods=1) or
    ``PodBFIORouter.route``'s level 2, integer-valued loads and sizes."""
    rng = np.random.default_rng(seed)
    npad = _pad_bucket(n)
    per = np.array_split(np.arange(n), pods)
    members = np.array_split(np.arange(R), pods)
    rmax = max(m.size for m in members)
    growth = np.arange(W, dtype=np.float64)
    base = np.full((pods, rmax, W), 1e30)
    caps = np.zeros((pods, rmax), np.int32)
    cands = np.zeros((pods, npad, W))
    valid = np.zeros((pods, npad), bool)
    for p, m in enumerate(members):
        base[p, :m.size] = rng.integers(0, 900, (m.size, 1)) + growth
        caps[p, :m.size] = npad
        k = per[p].size
        cands[p, :k] = rng.integers(2, 200, (k, 1)) + growth
        valid[p, :k] = True
    return (base.astype(np.float32), caps, cands.astype(np.float32), valid,
            np.array([p.size for p in per], np.int32))


@pytest.mark.parametrize("n,R,W,pods", [(5, 4, 1, 1), (13, 4, 1, 1),
                                        (40, 4, 1, 1), (9, 4, 9, 1),
                                        (30, 4, 3, 2)])
def test_solve_body_matches_reference(ref, n, R, W, pods):
    arrs = _router_inputs(n, R, W, pods)
    want = np.asarray(ref["assign_batch"](*(ref["jnp"].asarray(a)
                                            for a in arrs)))
    inputs = [torch.from_numpy(a) for a in arrs]
    with HostSyncGuard():
        got = bfio_assign_batch(*inputs)
    np.testing.assert_array_equal(got.numpy(), want)


def _loop_inputs(seed=3):
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.uniform(90, 100, 16), rng.uniform(1, 10, 48)])
    return 4, 8, 128, sizes, np.full(len(sizes), 6)


@pytest.mark.parametrize("kw", [{}, {"prefill_budget": 16.0}],
                         ids=["plain", "chunked"])
def test_loop_step_body_matches_reference(ref, kw):
    """One step and then three more (the step graph's body, repeated) with
    ``kv_pool == 0`` under the guard: every ``LoopState`` field ``==``."""
    Gl, Bl, W, sizes, rem = _loop_inputs()
    jrun = ref["make_loop"](Gl, Bl, W, **kw)
    trun = make_device_serving_loop(Gl, Bl, W, device="cpu", **kw)
    js = ref["init_loop"](Gl, Bl, sizes, rem, W)
    ts = init_loop_state(Gl, Bl, sizes, rem, W, device="cpu")
    for steps in (1, 3):
        js = jrun(js, steps)
        with HostSyncGuard():
            new = trun(ts, steps)
        assert all(a is not b for a, b in zip(new, ts))   # fresh tensors
        ts = new
        for field in js._fields:
            a, b = np.asarray(getattr(js, field)), getattr(ts, field).numpy()
            assert b.dtype == a.dtype and np.array_equal(a, b), field


def test_guard_catches_host_reads():
    x = torch.arange(6.0)
    for bad in (lambda: x.nonzero(), lambda: x.sum().item(),
                lambda: bool(x.any()), lambda: x[x > 2],
                lambda: torch.masked_select(x, x > 2),
                lambda: x * torch.tensor(2.0)):
        with pytest.raises(AssertionError), HostSyncGuard():
            bad()
    with HostSyncGuard():
        assert torch.where(x > 2, x, 0.0).shape == (6,)


def test_eager_switch_and_cpu_runs_the_body():
    """On a CPU device nothing is captured: ``Graphs.run`` runs the body on
    the arguments (host arrays moved to the device), ``repeat`` times."""
    assert not graphs.captures("cpu")
    with graphs.eager():
        assert not graphs.captures("cuda")
    g = graphs.Graphs("cpu")
    acc = torch.zeros(3)

    def body(a, b):
        acc.add_(a + b)
        return acc
    out = g.run("k", body, (np.ones(3, np.float32), torch.full((3,), 2.0)),
                repeat=4)
    assert out.tolist() == [12.0] * 3
    assert g.n_captured == g.n_replayed == 0
    assert set(graphs.launch_counters()) == {
        "rms_norm", "rms_norm_bwd", "paged_decode_attention", "bfio_swap",
        "decode_attention", "ssm_chunk_scan", "ssm_chunk_scan_bwd"}


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_capture.py` on the H100")
    return torch.device("cuda")


def _counts() -> dict:
    return {k: w.launches for k, w in graphs.launch_counters().items()}


def _serve(cfg, params, backend, mode, dev):
    from repro_torch.core import make_policy
    from repro_torch.serving import ServeRequest, ServingEngine
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(rid=i, tokens=rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(4, 30))),
        max_new_tokens=int(rng.integers(3, 12))) for i in range(14)]
    eng = ServingEngine(cfg, params, EngineConfig(
        n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
        cache_backend=backend, engine_mode=mode), make_policy("bfio_h8"),
        device=dev)
    for r in reqs:
        eng.submit(r)
    before = _counts()
    stats = eng.run()
    after = _counts()
    return (stats, [r.generated for r in reqs],
            {k: after[k] - before[k] for k in after}, eng.backend.graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,mode,arch", [
    ("paged", "vec", "granite-8b"), ("slot", "vec", "granite-8b"),
    ("slot", "ref", "granite-8b"), ("slot", "vec", "zamba2-1.2b"),
    ("paged", "vec", "qwen3-moe-30b-a3b")])
def test_captured_engine_equals_eager(cuda, backend, mode, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, 0, device=cuda)
    got = _serve(cfg, params, backend, mode, cuda)
    with graphs.eager():
        want = _serve(cfg, params, backend, mode, cuda)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert got[3].n_captured > 0 and got[3].n_replayed > 0
    assert want[3].n_captured == 0


@pytest.mark.cuda
def test_captured_solve_equals_eager(cuda):
    for n, R, W, pods in ((5, 4, 1, 1), (40, 4, 1, 1), (30, 4, 3, 2)):
        for seed in range(3):        # the later seeds replay the graph
            arrs = [torch.from_numpy(a).to(cuda)
                    for a in _router_inputs(n, R, W, pods, seed)]
            c0 = _counts()["bfio_swap"]
            got = bfio_assign_batch(*arrs)
            c1 = _counts()["bfio_swap"]
            with graphs.eager():
                want = bfio_assign_batch(*arrs)
            assert torch.equal(got, want)
            assert c1 - c0 == _counts()["bfio_swap"] - c1 == 8


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"prefill_budget": 16.0}])
def test_captured_loop_equals_eager(cuda, kw):
    Gl, Bl, W, sizes, rem = _loop_inputs()
    run = make_device_serving_loop(Gl, Bl, W, device=cuda, **kw)
    state = init_loop_state(Gl, Bl, sizes, rem, W, device=cuda)
    c0 = _counts()["bfio_swap"]
    got = run(run(state, 5), 7)
    c1 = _counts()["bfio_swap"]
    with graphs.eager():
        want = run(run(state, 5), 7)
    assert c1 - c0 == _counts()["bfio_swap"] - c1 == 4 * 12
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rebound_storage_captures_again(cuda):
    """A graph bakes in the pools' addresses: after ``k_pool`` is rebound
    the next decode captures again (never a replay against the old
    storage), and tokens and pools equal an eager backend's."""
    cfg = dataclasses.replace(get_smoke_config("granite-8b"), dtype="float32")
    params = init_params(cfg, 0, device=cuda)
    ec = EngineConfig(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
                      cache_backend="paged", paged_block_size=BS)
    gen = torch.Generator(device=cuda).manual_seed(0)
    mini = {"lengths": torch.full((N,), 5, dtype=torch.int32, device=cuda),
            "blocks": {k: torch.rand(cfg.n_layers, N, PROMPT, cfg.n_kv_heads,
                                     cfg.hd, device=cuda, generator=gen)
                       for k in ("k", "v")}}
    cap, eag = (make_cache_backend("paged", cfg, params, ec, cuda)
                for _ in range(2))
    for be in (cap, eag):
        be.write_prefill(mini, np.arange(N), np.arange(N))
    toks = np.arange(1, N + 1, dtype=np.int32)
    act = np.array([0, 2, 5])

    def both():
        got = cap.decode(toks, act, 4)
        with graphs.eager():
            want = eag.decode(toks, act, 4)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(cap.kv.k_pool, eag.kv.k_pool)
        assert torch.equal(cap.kv.v_pool, eag.kv.v_pool)
    both()
    both()
    assert (cap.graphs.n_captured, cap.graphs.n_replayed) == (1, 1)
    cap.kv.k_pool = cap.kv.k_pool.clone()
    both()
    assert (cap.graphs.n_captured, cap.graphs.n_replayed) == (2, 1)
