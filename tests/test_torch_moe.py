"""The port's MoE family (repro_torch.models.moe and the moe decoder)
against the reference (repro.models.moe, repro.models, repro.serving,
repro.fleet) on the same numpy-seeded inputs and bridged float32 weights.

The reference runs at its one-device mesh, built with ``make_cpu_mesh()``
(a bare ``jax.make_mesh`` has Explicit axes on newer JAX, which the
reference's MoE path does not take).  Held:

* ``router_topk`` and ``moe_ffn`` within 1e-5 at E=4, k=2 and E=40, k=8,
  with ``top_idx`` equal; tied router logits pick the lower expert index
  first, as ``jax.lax.top_k`` does; under a small capacity factor with
  padding rows in the batch the same (token, expert) picks are dropped,
  read off a probe model whose expert e writes only output column 1 + e;
* ``prefill_fn``, ``decode_fn``, ``chunk_prefill_fn`` and
  ``paged_decode_fn`` of granite-moe-3b-a800m and qwen3-moe-30b-a3b in
  their smoke sizes (and qwen3 at a capacity factor whose prefill must
  drop picks) within the dense tests' 1e-4, paged decode's greedy tokens
  equal;
* engine ``stats()``, workers, statuses, finish times and the resident-KV
  peak equal on both backends, with chunked and budgeted prefill, swap
  and recompute preemption and the prefix cache; stats only, not
  generations, as the reference's own MoE engine tests hold them
  (``tests/test_cache_backend.py::TestMoEFamily``: expert capacity couples
  a batch's rows);
* a barrier fleet of MoE replicas: stats and telemetry rows equal.

The reference is imported inside a fixture, so that the ``cuda`` case
(the card's MoE against the CPU's) also runs where JAX is not installed.
"""
import dataclasses
import types
import warnings

warnings.filterwarnings("ignore")

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import make_policy
from repro_torch.models import (
    chunk_prefill_fn,
    decode_fn,
    init_params,
    layer_pattern,
    paged_decode_fn,
    params_from_numpy,
    prefill_fn,
)
from repro_torch.models import moe

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL5 = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)           # the dense model tests'
BS, MAX_LEN = 8, 64
ROUTING = [(4, 2), (40, 8)]                # (experts, picks per token)
MOE_ARCHES = {"granite-moe": ("granite-moe-3b-a800m", {}),
              "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
              # 96 picks of 48 prefill rows over 4 experts of capacity 13
              "qwen3-moe-drops": ("qwen3-moe-30b-a3b",
                                  {"capacity_factor": 0.5})}
TINY_MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, n_experts=4,
                experts_per_token=2, moe_d_ff=64, vocab_size=128,
                dtype="float32")
G, B, MAX_SEQ = 2, 4, 64
ENGINE_MODES = {
    "slot": dict(cache_backend="slot"),
    "slot-chunked": dict(cache_backend="slot", prefill_chunk=8),
    "paged": dict(cache_backend="paged"),
    "paged-chunked": dict(cache_backend="paged", prefill_chunk=8),
    "paged-budget": dict(cache_backend="paged", prefill_chunk=8,
                         prefill_budget=12),
    "swap": dict(cache_backend="paged", paged_pool_blocks=16,
                 preemption_mode="swap"),
    "recompute": dict(cache_backend="paged", paged_pool_blocks=16,
                      preemption_mode="recompute"),
    "prefix": dict(cache_backend="paged", prefix_cache=True),
}


@pytest.fixture(scope="module")
def ref():
    """The reference package's MoE surface and its one-device mesh."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as smoke
    from repro.configs.base import ModelConfig as RefModelConfig
    from repro.launch.mesh import make_cpu_mesh
    from repro.models import moe as rmoe
    import repro.models as rmodels
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, mesh=make_cpu_mesh(), moe=rmoe, models=rmodels,
        smoke=smoke, ModelConfig=RefModelConfig)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_moe.py` on the H100")
    return torch.device("cuda")


def _ffn_params(rng, d, E, f, scale=0.3):
    return {"router": (scale * rng.normal(size=(d, E))).astype(np.float32),
            "w1": (scale * rng.normal(size=(E, d, f))).astype(np.float32),
            "w3": (scale * rng.normal(size=(E, d, f))).astype(np.float32),
            "w2": (scale * rng.normal(size=(E, f, d))).astype(np.float32)}


def _both(ref, x, p, E, k, **kw):
    """moe_ffn of the reference and of the port on the same inputs."""
    jnp = ref.jnp
    jo, ja = ref.moe.moe_ffn(jnp.asarray(x),
                             {n: jnp.asarray(v) for n, v in p.items()},
                             n_experts=E, k=k, mesh=ref.mesh,
                             batch_axes=("data",), **kw)
    to, ta = moe.moe_ffn(torch.from_numpy(x),
                         {n: torch.from_numpy(v) for n, v in p.items()},
                         n_experts=E, k=k, **kw)
    return (np.asarray(jo), float(ja)), (to.numpy(), float(ta))


# ----------------------------------------------------------------------
# router and FFN
# ----------------------------------------------------------------------

@pytest.mark.parametrize("E,k", ROUTING)
def test_router_topk_matches(ref, E, k):
    rng = np.random.default_rng(E)
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    w = (0.5 * rng.normal(size=(24, E))).astype(np.float32)
    jp, jw, ji = ref.moe.router_topk(ref.jnp.asarray(x), ref.jnp.asarray(w),
                                     k)
    tp, tw, ti = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    assert tp.dtype == torch.float32 and tw.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("E,k", ROUTING)
def test_tied_router_logits_pick_the_lower_index(ref, E, k):
    """Router columns of zeros give logits of exactly 0 (the even experts
    tie).  The first rows read x's first half of features, where expert
    1's column is positive and the other odd columns negative: they pick
    expert 1, then the lowest even experts.  The last rows read the second
    half, where every odd column is negative: they pick the k lowest even
    experts."""
    rng = np.random.default_rng(11 + E)
    d, T = 16, 6
    x = np.zeros((1, T, d), np.float32)
    x[0, :T // 2, :d // 2] = np.abs(rng.normal(size=(T // 2, d // 2))) + 0.1
    x[0, T // 2:, d // 2:] = np.abs(rng.normal(size=(T // 2, d // 2))) + 0.1
    w = (-np.abs(rng.normal(size=(d, E))) - 0.1).astype(np.float32)
    w[:d // 2, 1] *= -1.0
    zero = np.arange(E) % 2 == 0
    w[:, zero] = 0.0
    _, _, ji = ref.moe.router_topk(ref.jnp.asarray(x), ref.jnp.asarray(w), k)
    _, _, ti = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    evens = np.flatnonzero(zero)
    assert ji[0, 0].tolist() == [1] + evens[:k - 1].tolist()
    assert ji[0, -1].tolist() == evens[:k].tolist()


@pytest.mark.parametrize("E,k", ROUTING)
def test_moe_ffn_matches(ref, E, k):
    rng = np.random.default_rng(100 + E)
    d, f = 32, 24
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    p = _ffn_params(rng, d, E, f)
    (jo, ja), (to, ta) = _both(ref, x, p, E, k)
    np.testing.assert_allclose(to, jo, **TOL5)
    np.testing.assert_allclose(ta, ja, **TOL5)
    out, aux = moe.moe_ffn(torch.from_numpy(x), {
        n: torch.from_numpy(v) for n, v in p.items()}, n_experts=E, k=k,
        aux_loss=False)
    assert aux is None
    np.testing.assert_array_equal(out.numpy(), to)


def _probe(rng, E, k, n_feat=8, f=4):
    """A probe MoE whose expert e writes silu(1) * top_w only into output
    column 1 + e (x's column 0 is a constant 1 feeding hidden unit 0 of
    every expert), so a (token, expert) pick was kept iff that column is
    nonzero.  The router reads the last ``n_feat`` columns alone."""
    d = 1 + E + n_feat
    p = {"router": np.zeros((d, E), np.float32),
         "w1": np.zeros((E, d, f), np.float32),
         "w3": np.zeros((E, d, f), np.float32),
         "w2": np.zeros((E, f, d), np.float32)}
    p["router"][1 + E:] = rng.normal(size=(n_feat, E))
    p["w1"][:, 0, 0] = 1.0
    p["w3"][:, 0, 0] = 1.0
    for e in range(E):
        p["w2"][e, 0, 1 + e] = 1.0
    return d, p


@pytest.mark.parametrize("E,k", ROUTING)
def test_capacity_drops_match_with_padding_rows(ref, E, k):
    """A capacity factor of 0.5 (floor 1) drops picks; right-padded
    prompts and a whole padding row put one pad vector into the batch,
    routed and counted against capacity like the real rows."""
    rng = np.random.default_rng(200 + E)
    d, p = _probe(rng, E, k)
    Bt, S = 4, 12
    lens = np.array([12, 7, 3, 0])
    x = np.zeros((Bt, S, d), np.float32)
    x[..., 0] = 1.0
    x[..., 1 + E:] = rng.normal(size=(Bt, S, d - 1 - E))
    pad = rng.normal(size=(d - 1 - E,)).astype(np.float32)
    is_pad = np.arange(S)[None, :] >= lens[:, None]
    x[..., 1 + E:][is_pad] = pad
    kw = dict(capacity_factor=0.5, min_capacity=1)
    (jo, _), (to, _) = _both(ref, x, p, E, k, **kw)
    np.testing.assert_allclose(to, jo, **TOL5)
    jkept = jo.reshape(-1, d)[:, 1:1 + E] != 0
    tkept = to.reshape(-1, d)[:, 1:1 + E] != 0
    np.testing.assert_array_equal(tkept, jkept)
    T = Bt * S
    capacity = int(0.5 * T * k / E) + 1
    assert int(tkept.sum()) < T * k, "no pick was dropped"
    assert (tkept.sum(0) <= capacity).all()
    assert tkept[is_pad.reshape(-1)].any(), "no padding row took capacity"


# ----------------------------------------------------------------------
# the decoder's paths
# ----------------------------------------------------------------------

def _bridged(ref, arch, changes):
    jax = ref.jax
    jcfg = dataclasses.replace(ref.smoke(arch), dtype="float32", **changes)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **changes)
    jparams, _ = ref.models.split_params(
        ref.models.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module", params=list(MOE_ARCHES))
def models(request, ref):
    arch, changes = MOE_ARCHES[request.param]
    return _bridged(ref, arch, changes)


def _prompts(vocab, Bt=3, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(Bt, S)).astype(np.int32)
    return toks, np.array([S, 5, 11][:Bt], np.int32)


def _prefill_both(ref, models):
    jcfg, tcfg, jparams, tparams = models
    jnp = ref.jnp
    toks, lens = _prompts(tcfg.vocab_size)
    jl, jc = ref.models.prefill_fn(
        jcfg, jparams, {"tokens": jnp.asarray(toks),
                        "lengths": jnp.asarray(lens)},
        max_len=MAX_LEN, mesh=ref.mesh)
    tl, tc = prefill_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    return toks, lens, (jl, jc), (tl, tc)


def test_moe_layout_and_init(ref, models):
    """The port's own init and the bridged weights have the reference's
    tree; the layer pattern is one attention stack."""
    jcfg, tcfg, jparams, tparams = models
    own = init_params(tcfg, 0, device="cpu")
    for path, leaf in ref.jax.tree_util.tree_leaves_with_path(jparams):
        t, o = tparams, own
        for key in (q.key for q in path):
            t, o = t[key], o[key]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape)
        assert t.dtype == o.dtype
    ffn = own["blocks"]["ffn"]
    E, d, f = tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff
    assert tuple(ffn["w1"].shape) == (tcfg.n_layers, E, d, f)
    assert tuple(ffn["w2"].shape) == (tcfg.n_layers, E, f, d)
    assert layer_pattern(tcfg) == [("blocks", "attn", tcfg.n_layers)]


def test_prefill_logits_match(ref, models):
    _, lens, (jl, jc), (tl, tc) = _prefill_both(ref, models)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)
    np.testing.assert_array_equal(tc["lengths"].numpy(), lens)


def test_decode_logits_match(ref, models):
    """Four full-batch decode steps on the prefill's cache, each fed the
    reference's greedy token."""
    jcfg, tcfg, jparams, tparams = models
    _, _, (jl, jc), (_, tc) = _prefill_both(ref, models)
    tok = np.asarray(ref.jnp.argmax(jl, -1), np.int32)
    for _ in range(4):
        jl, jc = ref.models.decode_fn(jcfg, jparams, jc,
                                      ref.jnp.asarray(tok), mesh=ref.mesh)
        tl, tc = decode_fn(tcfg, tparams, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(ref.jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_chunk_prefill_matches(ref, models):
    jcfg, tcfg, jparams, tparams = models
    jnp = ref.jnp
    rng = np.random.default_rng(6)
    n, C = 3, 8
    toks = rng.integers(1, tcfg.vocab_size, size=(n, C)).astype(np.int32)
    offs = np.array([0, 8, 16], np.int32)
    clens = np.array([8, 5, 0], np.int32)        # the last row is padding
    kv = {name: rng.normal(size=(tcfg.n_layers, n, MAX_LEN, tcfg.n_kv_heads,
                                 tcfg.hd)).astype(np.float32)
          for name in ("k", "v")}
    jl, jc = ref.models.chunk_prefill_fn(
        jcfg, jparams, {"lengths": jnp.asarray(offs),
                        "blocks": {n_: jnp.asarray(v) for n_, v in kv.items()}},
        jnp.asarray(toks), jnp.asarray(offs), jnp.asarray(clens),
        mesh=ref.mesh)
    tl, tc = chunk_prefill_fn(
        tcfg, tparams, {"lengths": torch.from_numpy(offs),
                        "blocks": {n_: torch.from_numpy(v.copy())
                                   for n_, v in kv.items()}},
        torch.from_numpy(toks), torch.from_numpy(offs),
        torch.from_numpy(clens))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)


def test_paged_decode_greedy_tokens_match(ref, models):
    """Eight paged decode steps over permuted pool blocks; the port's
    kernel path (its plain version on the CPU) against the reference's
    gather oracle."""
    jcfg, tcfg, jparams, tparams = models
    jnp = ref.jnp
    _, lens, (jl, jc), _ = _prefill_both(ref, models)
    Bt = lens.size
    mb = MAX_LEN // BS
    n_pool = Bt * mb + 3
    perm = np.random.default_rng(1).permutation(n_pool)
    tables = perm[:Bt * mb].reshape(Bt, mb).astype(np.int32)
    ck, cv = np.asarray(jc["blocks"]["k"]), np.asarray(jc["blocks"]["v"])
    kp = np.zeros((tcfg.n_layers, n_pool, BS) + ck.shape[3:], np.float32)
    vp = np.zeros_like(kp)
    for b in range(Bt):
        for j in range(-(-int(lens[b]) // BS)):
            kp[:, tables[b, j]] = ck[:, b, j * BS:(j + 1) * BS]
            vp[:, tables[b, j]] = cv[:, b, j * BS:(j + 1) * BS]
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jtok = np.asarray(jnp.argmax(jl, -1), np.int32)
    ttok = jtok.copy()
    length = lens.copy()
    for _ in range(8):
        length = length + 1
        pos = length - 1
        blk = tables[np.arange(Bt), pos // BS].astype(np.int32)
        off = (pos % BS).astype(np.int32)
        jtok, jkp, jvp = ref.models.paged_decode_fn(
            jcfg, jparams, jkp, jvp, jnp.asarray(tables),
            jnp.asarray(length), jnp.asarray(blk), jnp.asarray(off),
            jnp.asarray(jtok), block_size=BS, attn_impl="gather",
            mesh=ref.mesh)
        jtok = np.asarray(jtok)
        tnext, tkp, tvp = paged_decode_fn(
            tcfg, tparams, tkp, tvp, torch.from_numpy(tables),
            torch.from_numpy(length), torch.from_numpy(blk),
            torch.from_numpy(off), torch.from_numpy(ttok), block_size=BS)
        ttok = tnext.numpy()
        np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)


def test_bridge_keeps_the_float32_router_of_a_bf16_model(ref):
    """In a bf16 model the router stays float32 (the reference's
    ``_moe_init``); the bridge keeps each leaf's dtype, bf16 exactly."""
    jax = ref.jax
    jcfg = ref.smoke("qwen3-moe-30b-a3b")
    assert jcfg.dtype == "bfloat16"
    jparams, _ = ref.models.split_params(
        ref.models.init_params(jcfg, jax.random.PRNGKey(2)))
    tree = jax.tree.map(np.asarray, jparams)
    tp = params_from_numpy(tree, device="cpu")["blocks"]["ffn"]
    assert tp["router"].dtype == torch.float32
    for name in ("w1", "w2", "w3"):
        assert tp[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[name].float().numpy(),
            np.asarray(tree["blocks"]["ffn"][name], np.float32))
    own = init_params(get_smoke_config("qwen3-moe-30b-a3b"), 0,
                      device="cpu")["blocks"]["ffn"]
    assert own["router"].dtype == torch.float32
    assert own["w1"].dtype == torch.bfloat16


def test_full_configs_are_the_published_widths():
    """The two full configs this family serves (init is not run here)."""
    q, g = get_config("qwen3-moe-30b-a3b"), get_config("granite-moe-3b-a800m")
    assert (q.n_layers, q.d_model, q.n_experts, q.experts_per_token,
            q.moe_d_ff) == (48, 2048, 128, 8, 768)
    assert (g.n_layers, g.d_model, g.n_experts, g.experts_per_token,
            g.moe_d_ff) == (32, 1536, 40, 8, 512)
    assert layer_pattern(q) == [("blocks", "attn", 48)]


# ----------------------------------------------------------------------
# engine and fleet
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(ref):
    jcfg = ref.ModelConfig(**TINY_MOE)
    jparams, _ = ref.models.split_params(
        ref.models.init_params(jcfg, ref.jax.random.PRNGKey(1)))
    tparams = params_from_numpy(ref.jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, ModelConfig(**TINY_MOE), tparams


def _stream(cls, mode, n=12, seed=4):
    """The reference engine tests' stream; longer decodes under memory
    pressure, shared prompt heads for the prefix cache."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 128, size=20) for _ in range(3)]
    out = []
    for i in range(n):
        toks = rng.integers(1, 128, size=int(rng.integers(4, 30)))
        if mode == "prefix":
            toks = np.concatenate([heads[i % 3],
                                   toks[:int(rng.integers(1, 9))]])
        max_new = int(rng.integers(12, 30) if mode in ("swap", "recompute")
                      else rng.integers(3, 10))
        out.append(cls(rid=i, tokens=toks, max_new_tokens=max_new))
    return out


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_stats_match_reference(ref, tiny, mode):
    from repro.core import make_policy as ref_make_policy
    from repro.serving import EngineConfig as RefEngineConfig
    from repro.serving import ServeRequest as RefServeRequest
    from repro.serving import ServingEngine as RefServingEngine
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(n_workers=G, slots_per_worker=B, max_seq_len=MAX_SEQ,
              **ENGINE_MODES[mode])
    je = RefServingEngine(jcfg, jparams, RefEngineConfig(**kw),
                          ref_make_policy("bfio_h8"), mesh=ref.mesh)
    te = ServingEngine(tcfg, tparams, EngineConfig(**kw),
                       make_policy("bfio_h8"), device="cpu")
    jr, tr = _stream(RefServeRequest, mode), _stream(ServeRequest, mode)
    for e, reqs in ((je, jr), (te, tr)):
        for r in reqs:
            e.submit(r)
    js, ts = je.run(), te.run()
    assert ts == js
    for a, b in zip(jr, tr):
        assert (b.worker, b.status, b.t_finish, len(b.generated)) == (
            a.worker, a.status, a.t_finish, len(a.generated))
    assert te.kv_peak_bytes == je.kv_peak_bytes
    if mode in ("swap", "recompute"):
        assert ts["preemptions"] > 0
    if mode == "prefix":
        assert ts["prefix_hits"] > 0


def test_barrier_fleet_of_moe_replicas_matches_reference(ref, tiny):
    from repro.fleet import FleetServer as RefFleetServer
    from repro.fleet import FleetTelemetry as RefFleetTelemetry
    from repro.fleet import make_scenario as ref_make_scenario
    from repro.serving import EngineConfig as RefEngineConfig
    from repro_torch.fleet import FleetServer, FleetTelemetry, make_scenario
    from repro_torch.serving import EngineConfig
    jcfg, jparams, tcfg, tparams = tiny
    ec = dict(n_workers=2, slots_per_worker=2, max_seq_len=64,
              cache_backend="paged", step_overhead=1e-3, t_token=2e-4)
    sc = dict(n_requests=16, n_replicas=4, n_workers=2, slots_per_worker=2,
              max_seq_len=64, vocab_size=128, seed=1, step_overhead=1e-3,
              t_token=2e-4)
    runs = []
    for fleet_cls, tel_cls, ec_cls, make, cfg, params, dev in (
            (RefFleetServer, RefFleetTelemetry, RefEngineConfig,
             ref_make_scenario, jcfg, jparams, {"mesh": ref.mesh}),
            (FleetServer, FleetTelemetry, EngineConfig, make_scenario,
             tcfg, tparams, {"device": "cpu"})):
        tel = tel_cls()
        fleet = fleet_cls(cfg, params, ec_cls(**ec), n_replicas=4,
                          router="bfio", policy="bfio_h0", telemetry=tel,
                          **dev)
        fleet.submit_scenario(make("flash_crowd", **sc))
        fleet.run()
        runs.append((fleet.stats(), tel.steps, tel.requests))
    assert runs[1] == runs[0]
    assert runs[1][0]["completed"] == 16


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("E,k", ROUTING)
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, E, k):
    """Inputs whose k-th and (k+1)-th router probabilities are at least
    1e-5 apart, far above float32 rounding, so both devices pick the same
    experts."""
    rng = np.random.default_rng(300 + E)
    d, f = 64, 32
    x = torch.from_numpy(rng.normal(size=(4, 9, d)).astype(np.float32))
    p = {n: torch.from_numpy(v) for n, v in
         _ffn_params(rng, d, E, f).items()}
    probs, _, _ = moe.router_topk(x, p["router"], k)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert (top[..., k - 1] - top[..., k]).min() > 1e-5
    want, _ = moe.moe_ffn(x, p, n_experts=E, k=k)
    got, _ = moe.moe_ffn(x.to(cuda), {n: v.to(cuda) for n, v in p.items()},
                         n_experts=E, k=k)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
