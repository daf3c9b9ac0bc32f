"""The port's contiguous slot backend (repro_torch.serving, ``cache_backend=
"slot"``) against the reference engine on the same request stream.

Bridged float32 weights on the CPU, so the reference's exactness carries
over: ``stats()`` equal with ``==`` (the engine's time and energy are
modelled), every request's generation, worker, status and finish time
equal — on the tiny dense config of ``tests/test_cache_backend.py``
(synchronous and chunked prefill, ``fcfs`` and ``bfio_h8``), a
sliding-window dense config whose decode runs past the window (rolling
cache), a request decoding past ``max_seq_len`` (idle and live rows whose
KV writes the reference drops), the tiny SSM config and zamba2-1.2b-smoke.
Inside the port, the slot and paged backends agree bit for bit on the
dense config (the reference's ``TestSlotPagedParity``), and compact
decode drops the writes of its padding rows.
"""
import warnings

warnings.filterwarnings("ignore")

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import make_policy as jax_make_policy
from repro.launch.mesh import make_cpu_mesh
from repro.models import init_params as jax_init_params
from repro.models import split_params
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_policy
from repro_torch.models import init_cache, params_from_numpy
from repro_torch.serving import (
    EngineConfig,
    ServeRequest,
    ServingEngine,
    SlotCacheBackend,
    make_cache_backend,
)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
WINDOW = dict(TINY, name="tiny-window", sliding_window=24)
SSM = dict(name="tiny-ssm", family="ssm", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=128, ssm_state=16,
           dtype="float32")
G, B, MAX_SEQ = 2, 4, 64


def _bridged(jcfg):
    jparams, _ = split_params(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_cpu_mesh()


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port params) by name."""
    out = {}
    for name, kw in (("tiny", TINY), ("window", WINDOW), ("ssm", SSM)):
        jcfg = JaxModelConfig(**kw)
        out[name] = (jcfg, ModelConfig(**kw)) + _bridged(jcfg)
    jcfg = dataclasses.replace(jax_smoke_config("zamba2-1.2b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                               dtype="float32")
    out["zamba2"] = (jcfg, tcfg) + _bridged(jcfg)
    return out


def _requests(cls, n=14, seed=3, max_new=(3, 10), plen=(4, 30)):
    """The reference's stream (tests/test_cache_backend.py)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(1, 128,
                                           size=int(rng.integers(*plen))),
                max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _port_engine(tcfg, tparams, policy, **kw):
    ec = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              cache_backend="slot")
    ec.update(kw)
    return ServingEngine(tcfg, tparams, EngineConfig(**ec),
                         make_policy(policy), device="cpu")


def _run_both(models, mesh, name, policy, *, stream=None, **kw):
    jcfg, tcfg, jparams, tparams = models[name]
    stream = stream or {}
    ec = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              cache_backend="slot")
    ec.update(kw)
    je = JaxServingEngine(jcfg, jparams, JaxEngineConfig(**ec),
                          jax_make_policy(policy), mesh=mesh)
    te = _port_engine(tcfg, tparams, policy, **kw)
    jr = _requests(JaxServeRequest, **stream)
    tr = _requests(ServeRequest, **stream)
    for e, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            e.submit(r)
    return je.run(), te.run(), jr, tr


def _assert_same(js, ts, jr, tr):
    assert ts == js
    for a, b in zip(jr, tr):
        assert b.generated == a.generated, f"request {a.rid} diverged"
        assert (b.worker, b.status, b.t_finish) == (a.worker, a.status,
                                                   a.t_finish)


@pytest.mark.parametrize("mode", ["sync", "chunked"])
@pytest.mark.parametrize("policy", ["fcfs", "bfio_h8"])
def test_dense_matches_reference(models, mesh, policy, mode):
    kw = dict(prefill_chunk=8) if mode == "chunked" else {}
    _assert_same(*_run_both(models, mesh, "tiny", policy, **kw))


def test_sliding_window_past_the_window(models, mesh):
    """Rolling KV cache of 24 positions; prompts fit the prefill pad of 16
    and decodes run to 50 tokens, far past the window."""
    js, ts, jr, tr = _run_both(
        models, mesh, "window", "jsq", prefill_pad=16,
        stream=dict(plen=(4, 17), max_new=(20, 35)))
    _assert_same(js, ts, jr, tr)
    assert max(len(r.tokens) + len(r.generated) for r in tr) > 24


def test_decode_past_max_seq_len(models, mesh):
    """Requests outgrowing max_seq_len=32 keep decoding on frozen KV: the
    reference drops their out-of-bounds writes, and so must the port, in
    compact decode (one request) and in full-batch decode (six of eight
    slots, where idle rows' lengths grow past max_seq_len too)."""
    for n in (1, 6):
        js, ts, jr, tr = _run_both(
            models, mesh, "tiny", "fcfs", max_seq_len=32,
            stream=dict(n=n, seed=5, plen=(8, 20), max_new=(30, 40)))
        _assert_same(js, ts, jr, tr)
        assert all(len(r.generated) >= 30 for r in tr)


@pytest.mark.parametrize("policy", ["fcfs", "bfio_h8"])
def test_ssm_matches_reference(models, mesh, policy):
    _assert_same(*_run_both(models, mesh, "ssm", policy))


def test_zamba2_smoke_matches_reference(models, mesh):
    _assert_same(*_run_both(models, mesh, "zamba2", "bfio_h8"))


@pytest.mark.parametrize("policy", ["fcfs", "jsq", "bfio_h0"])
def test_slot_paged_parity(models, policy):
    """The reference's TestSlotPagedParity, inside the port: the paged
    backend's default kernel path (plain on the CPU) is a pure layout
    change on the dense config."""
    _, tcfg, _, tparams = models["tiny"]
    out = []
    for backend in ("slot", "paged"):
        eng = _port_engine(tcfg, tparams, policy, cache_backend=backend)
        reqs = _requests(ServeRequest)
        for r in reqs:
            eng.submit(r)
        out.append((eng.run(), reqs))
    (sa, ra), (sb, rb) = out
    assert sa == sb
    for a, b in zip(ra, rb):
        assert a.generated == b.generated and a.worker == b.worker


def test_compact_decode_padding_rows_drop_writes(models):
    """Compact decode at bucket 4 over 2 active slots: the padding rows
    gather slot 0's row and must not write it back; the active rows
    advance."""
    _, tcfg, _, tparams = models["tiny"]
    ec = EngineConfig(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ)
    be = SlotCacheBackend(tcfg, tparams, ec, "cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in (be.cache["blocks"]["k"], be.cache["blocks"]["v"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    be.cache["lengths"].copy_(torch.tensor([5, 7, 9, 3, 4, 6, 8, 2],
                                           dtype=torch.int32))
    before = {k: v.clone() for k, v in be.cache["blocks"].items()}
    lens0 = be.cache["lengths"].clone()
    active = np.array([2, 5])
    toks = np.arange(1, 9, dtype=np.int32)
    nxt = be.decode(toks, active, bucket=4)
    assert nxt.shape == (2,)
    idle = [s for s in range(8) if s not in active]
    for k, v in be.cache["blocks"].items():
        assert torch.equal(v[:, idle], before[k][:, idle])
        for s in active:
            assert not torch.equal(v[:, s], before[k][:, s])
    lens = be.cache["lengths"]
    assert torch.equal(lens[idle], lens0[idle])
    assert torch.equal(lens[active], lens0[active] + 1)


def test_default_engine_config_builds(models):
    """EngineConfig() names the slot backend: it builds and serves."""
    _, tcfg, _, tparams = models["tiny"]
    eng = ServingEngine(tcfg, tparams, EngineConfig(), make_policy("fcfs"),
                        device="cpu")
    assert eng.backend.name == "slot"
    assert eng.cache is eng.backend.cache
    reqs = _requests(ServeRequest, n=3)
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and not r.failed for r in reqs)


def test_resident_bytes_count_the_flat_cache(models):
    _, tcfg, _, tparams = models["ssm"]
    ec = EngineConfig(n_workers=1, slots_per_worker=2, max_seq_len=64)
    be = make_cache_backend("slot", tcfg, tparams, ec, "cpu")
    cache = init_cache(tcfg, 2, 64, device="cpu")
    want = 2 * 4        # lengths
    for g in ("m0",):
        want += sum(t.nbytes for t in cache[g].values())
    assert be.resident_kv_bytes() == want
    with pytest.raises(ValueError, match="unknown cache backend"):
        make_cache_backend("mmap", tcfg, tparams, ec, "cpu")


def test_recurrent_families_reject_chunked_and_paged(models):
    for name in ("ssm", "zamba2"):
        _, tcfg, _, tparams = models[name]
        with pytest.raises(ValueError, match="chunked prefill"):
            _port_engine(tcfg, tparams, "fcfs", prefill_chunk=8)
        with pytest.raises(ValueError, match="attention-family"):
            _port_engine(tcfg, tparams, "fcfs", cache_backend="paged")
