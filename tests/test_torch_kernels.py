"""The port's kernels (repro_torch.kernels) against the reference's
Pallas kernels and jnp functions.

On the CPU each wrapper runs its plain PyTorch version, which is held
against ``rms_norm_pallas`` / ``paged_decode_attention_pallas`` /
``decode_attention_pallas`` / ``ssm_chunk_scan_pallas`` in interpret mode
and against the reference's own oracles and model functions, on the same
inputs drawn from a numpy seed.  Tolerances are the reference's kernel
tolerances (``tests/test_kernels.py``): float32 2e-5, bfloat16 2e-2 for
attention and norms; float32 1e-3, bfloat16 1e-1 for the scan.
The ``cuda``-marked cases hold each Hopper kernel against its plain
version on the card and skip without one; the reference is imported
inside a fixture, so the card cases also run where JAX is not installed.
"""
import types
import warnings

warnings.filterwarnings("ignore")

import numpy as np
import pytest
import torch

from repro_torch.kernels import bfio_swap as bs
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rms_norm as rk
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models.attention import decode_attention as model_decode

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RMS_SHAPES = [(4, 32), (2, 7, 96), (1, 128), (5, 3, 2, 64)]
# every width the port's paths norm over: xlstm 1024, zamba2 2048,
# minitron 3072, granite-8b 4096 (and zamba2's d_inner), granite-34b 6144,
# qwen2-72b 8192; the row counts of a decode step (1-33) and of prefill
NORM_WIDTHS = [1024, 2048, 3072, 4096, 6144, 8192]
NORM_ROWS = [1, 7, 32, 33, 132, 2048]
PAGED_CASES = [(2, 4, 2, 32, 8, 4), (3, 8, 4, 64, 16, 5),
               (1, 16, 2, 128, 32, 3)]
# (C, G, N, W, kind): the chip smoke's two shapes (the router's bucket
# with integer loads, pod scale with random floats), N below the kernel's
# 64-row tile, and ragged tiles; then pod_bfio_p2's two pods of two
# replicas, one and two workers (argsort's positions clamped to row G-1),
# exact ties (also over more than 32 workers), all-zero loads with -0.0,
# the pod router's padding rows of load 1e30, int64 assign, a cluster
# with no feasible pair, and windows at and just past the 12 slots the
# kernel keeps in registers (each W up to 12 has its own compiled kernel;
# wider ones walk their slots in chunks), and wider; and two shapes whose
# j do not fit one staged tile (N over 1,024; a window of 100), so the
# kernel searches one tile while copying the next
SWAP_CASES = [(1, 4, 64, 1, 24), (8, 32, 512, 9, None), (1, 3, 17, 2, None),
              (3, 4, 33, 3, None), (2, 5, 130, 4, 100),
              (2, 2, 64, 1, 24), (2, 2, 16, 3, "ties"), (2, 1, 40, 2, None),
              (3, 3, 70, 2, "ties"), (2, 70, 90, 3, "ties"),
              (2, 4, 50, 3, "zeros"), (2, 6, 64, 9, "pad"),
              (3, 4, 33, 3, "int64"), (2, 3, 40, 2, "one_worker"),
              (1, 8, 70, 12, None), (2, 5, 100, 13, None),
              (1, 8, 70, 16, None), (2, 5, 100, 17, None),
              (1, 3, 40, 40, "ties"), (1, 4, 1100, 2, None),
              (2, 5, 300, 100, "ties")]
DTYPES = {"float32": ("float32", torch.float32, 2e-5),
          "bfloat16": ("bfloat16", torch.bfloat16, 2e-2)}
# (B, Hq, Hkv, hd, L, blk_l): the reference's sweep (tests/test_kernels.py)
DECODE_CASES = [(1, 2, 1, 32, 64, 32), (2, 4, 2, 64, 128, 64),
                (2, 8, 8, 64, 200, 128), (1, 16, 2, 128, 1024, 512),
                (3, 6, 6, 64, 96, 96)]
# (B, S, H, dk, dv, chunk): the reference's sweep
SSM_CASES = [(1, 32, 1, 8, 8, 16), (2, 64, 3, 16, 8, 16),
             (2, 128, 2, 64, 64, 128), (1, 48, 4, 32, 33, 16)]
SSM_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
# (B, S, H, dk, dv, chunk, initial state, final-state gradient[, "decay"]):
# the backward kernel's cases, every padded chunk (16 to 128), one and
# several 64-wide dk and dv tiles, zamba2's and xlstm's widths (dv 513: a
# 1-wide last tile), chunks short of their padded size (8 in 16, 40 in
# 64, 100 in 128: the chunk ops takes for a sequence shorter than 128),
# xlstm's widths over 8 chunks from an initial state, and "decay": log
# decay <= -1 at every step, so that most of a chunk's pairs fall outside
# the +-60 clip
SSM_BWD_CASES = [(1, 32, 1, 8, 8, 16, False, False),
                 (2, 64, 3, 16, 8, 16, True, True),
                 (1, 48, 4, 32, 33, 16, False, True),
                 (2, 96, 2, 20, 40, 32, True, False),
                 (2, 128, 3, 64, 64, 64, True, True),
                 (2, 256, 32, 64, 128, 128, False, False),
                 (1, 256, 4, 512, 513, 128, True, True),
                 (2, 384, 2, 64, 128, 128, True, True),
                 (2, 80, 3, 16, 24, 40, True, True),
                 (1, 100, 2, 64, 128, 100, False, True),
                 (1, 64, 2, 8, 12, 8, True, True),
                 (1, 1024, 4, 512, 513, 128, True, True),
                 (2, 256, 4, 64, 128, 128, True, True, "decay")]
# sliding window / rolling cases of the model function: (mode, window)
MASKS = [("causal", 0), ("window", 24), ("rolling", 24)]
# granite-34b's head layout (configs/granite_34b.py): 48 query heads over
# one KV head, hd=128 (G * hd = 6144), at a small B and L
G34 = dict(Hq=48, Hkv=1, hd=128)
# the kernels' split length (decode_attention.SPLIT_LEN, and
# paged_attention.split_len at block size 16)
SPLIT = 64


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jax_ops
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.paged_attention import paged_decode_attention_pallas
    from repro.kernels.rms_norm import rms_norm_pallas
    from repro.kernels.ssm_scan import ssm_chunk_scan_pallas
    from repro.models.attention import decode_attention
    from repro.models.layers import rms_norm
    from repro.serving.paged_cache import paged_decode_attention_ref
    return types.SimpleNamespace(
        jnp=jnp, rms_norm_pallas=rms_norm_pallas, model_rms_norm=rms_norm,
        paged_pallas=paged_decode_attention_pallas,
        paged_ref=paged_decode_attention_ref,
        decode_pallas=decode_attention_pallas, model_decode=decode_attention,
        ssm_pallas=ssm_chunk_scan_pallas, ops=jax_ops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_kernels.py` on the H100")
    return torch.device("cuda")


def _swap_inputs(C, G, N, W, kind, seed=0):
    """``kind`` an int n: integer loads and sizes, the first n rows valid
    (the router's padded bucket); None: random floats, ragged ``valid``,
    ``assign`` with -1s (the reference's fixtures); or one of the edge
    cases: ``ties`` (loads and sizes in {0, 1, 2}), ``zeros`` (loads of
    0.0 and -0.0), ``pad`` (rows 3.. of load 1e30 that nothing is
    assigned to, as the pod router pads), ``int64`` (assign as int64),
    ``one_worker`` (the last cluster's admitted rows on one worker)."""
    rng = np.random.default_rng(seed)
    if isinstance(kind, int):
        loads = rng.integers(0, 2048, (C, G, W)).astype(np.float32)
        cands = rng.integers(2, 256, (C, N, W)).astype(np.float32)
        valid = np.zeros((C, N), bool)
        valid[:, :kind] = True
        assign = np.where(valid, rng.integers(0, G, (C, N)), -1)
    else:
        loads = rng.uniform(0, 10, (C, G, W)).astype(np.float32)
        cands = rng.uniform(0, 5, (C, N, W)).astype(np.float32)
        assign = rng.integers(-1, G, (C, N))
        valid = rng.random((C, N)) > 0.1
    if kind == "ties":
        loads = rng.integers(0, 3, (C, G, W)).astype(np.float32)
        cands = rng.integers(0, 3, (C, N, W)).astype(np.float32)
    elif kind == "zeros":
        loads = np.where(rng.random((C, G, W)) < 0.5, -0.0, 0.0)
        loads = loads.astype(np.float32)
    elif kind == "pad":
        loads[:, 3:] = 1e30
        loads[:, :3] = rng.integers(0, 900, (C, 3, W))
        assign = np.where(valid, rng.integers(0, 3, (C, N)), -1)
    elif kind == "one_worker":
        assign[-1] = np.where(assign[-1] >= 0, 0, -1)
    assign = assign.astype(np.int64 if kind == "int64" else np.int32)
    return [torch.from_numpy(a) for a in (loads, cands, assign, valid)]


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _t32(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _rms_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape[-1:]).astype(np.float32))


def _paged_inputs(B, Hq, Hkv, hd, bs, mb, seed=3):
    """The reference's fixture (tests/test_paged_cache.py): permuted
    physical blocks, ragged lengths in [1, mb * bs]."""
    rng = np.random.default_rng(seed)
    npool = mb * B + 4
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, bs, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, bs, Hkv, hd)).astype(np.float32)
    perm = rng.permutation(npool)
    bt = np.full((B, mb), -1, np.int32)
    lens = np.zeros(B, np.int32)
    ptr = 0
    for b in range(B):
        L = int(rng.integers(1, mb * bs + 1))
        n = -(-L // bs)
        bt[b, :n] = perm[ptr:ptr + n]
        ptr += n
        lens[b] = L
    return q, kp, vp, bt, lens


def _paged_fixed(lens, Hq, Hkv, hd, bs, mb, seed):
    """Paged inputs with the given lengths: each row's live blocks drawn
    from a permutation of the pool, so they lie apart and out of order."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    npool = mb * B + 4
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, bs, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, bs, Hkv, hd)).astype(np.float32)
    perm = rng.permutation(npool)
    bt = np.full((B, mb), -1, np.int32)
    ptr = 0
    for b, n_tok in enumerate(lens):
        n = -(-n_tok // bs)
        bt[b, :n] = perm[ptr:ptr + n]
        ptr += n
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _decode_inputs(B, Hq, Hkv, hd, L, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, L + 1, B)
    return q, k, v, np.asarray(lens, np.int32)


def _mask_lens(mode, B, L, seed=0):
    """Ragged lengths for a mask mode: within L (causal, window) or past L
    (rolling), with 1 and L among them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, B) if mode != "rolling" \
        else rng.integers(L + 1, 3 * L, B)
    lens[0] = 1
    lens[-1] = L
    return lens.astype(np.int32)


def _ssm_inputs(B, S, H, dk, dv, seed=0):
    """The reference's fixture: a <= 0, g >= 0."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(B, S, H))).astype(np.float32),
            np.abs(rng.normal(size=(B, S, H))).astype(np.float32))


class TestRMSNormPlain:
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_matches_pallas_and_model_layer(self, ref, shape, dtype):
        jdt, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs(shape)
        jx, jsc = ref.jnp.asarray(x, jdt), ref.jnp.asarray(sc)
        want_pallas = _np32(ref.rms_norm_pallas(jx, jsc, interpret=True))
        want_layer = _np32(ref.model_rms_norm(jx, jsc))
        got = rk.rms_norm_plain(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(sc))
        assert got.dtype == tdt and tuple(got.shape) == shape
        for want in (want_pallas, want_layer):
            np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    def test_cpu_wrapper_takes_plain_path(self):
        x, sc = _rms_inputs((3, 64))
        before = rk.rms_norm.launches
        got = ops.rms_norm(torch.from_numpy(x), torch.from_numpy(sc))
        want = rk.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(sc))
        assert torch.equal(got, want)
        assert rk.rms_norm.launches == before == 0

    def test_other_device_raises(self):
        x = torch.empty((2, 8), device="meta")
        with pytest.raises(ValueError, match="device"):
            rk.rms_norm(x, torch.ones(8, device="meta"))

    @pytest.mark.parametrize("width", NORM_WIDTHS)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_add_plain_matches_model_layer(self, ref, width, dtype):
        """The residual add + norm against the reference's
        ``layers.rms_norm(x + r)``: the sum equal, the norm within the
        kernel tolerance."""
        jdt, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs((4, width), seed=1)
        r, _ = _rms_inputs((4, width), seed=2)
        jx, jr = ref.jnp.asarray(x, jdt), ref.jnp.asarray(r, jdt)
        js = jx + jr
        want = _np32(ref.model_rms_norm(js, ref.jnp.asarray(sc)))
        s, got = rk.add_rms_norm_plain(torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(r).to(tdt),
                                       torch.from_numpy(sc))
        assert s.dtype == got.dtype == tdt
        np.testing.assert_array_equal(_t32(s), _np32(js))
        np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    def test_cpu_add_wrapper_takes_plain_path(self):
        x, sc = _rms_inputs((3, 64))
        r, _ = _rms_inputs((3, 64), seed=1)
        xt, rt, st = (torch.from_numpy(a) for a in (x, r, sc))
        before = rk.rms_norm.launches
        s, got = ops.add_rms_norm(xt, rt, st)
        s0, want = rk.add_rms_norm_plain(xt, rt, st)
        assert torch.equal(s, s0) and torch.equal(got, want)
        assert torch.equal(s, xt + rt)
        assert torch.equal(got, rk.rms_norm_plain(xt + rt, st))
        assert rk.rms_norm.launches == before == 0

    def test_model_layer_without_residual_is_the_norm(self):
        from repro_torch.models import layers
        x, sc = _rms_inputs((3, 64))
        xt, st = torch.from_numpy(x), torch.from_numpy(sc)
        s, got = layers.add_rms_norm(xt, None, st)
        assert s is xt and torch.equal(got, rk.rms_norm_plain(xt, st))

    def test_add_other_device_raises(self):
        x = torch.empty((2, 8), device="meta")
        with pytest.raises(ValueError, match="device"):
            rk.add_rms_norm(x, x, torch.ones(8, device="meta"))


class TestRMSNormBackwardPlain:
    """``rms_norm_bwd_plain`` against autograd through ``rms_norm_plain``
    (and ``add_rms_norm_plain``) on the CPU; float32 within 1e-5 (the same
    derivative, rounded in another order), bfloat16 within the kernel
    tolerance."""

    @pytest.mark.parametrize("shape", RMS_SHAPES + [(6, 4096)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("fused", [False, True])
    def test_matches_autograd_of_plain(self, shape, dtype, fused):
        _, tdt, tol = DTYPES[dtype]
        tol = min(tol, 1e-5) if dtype == "float32" else tol
        x, sc = _rms_inputs(shape, seed=11)
        g, _ = _rms_inputs(shape, seed=12)
        gs, _ = _rms_inputs(shape, seed=13)
        xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
        rt = torch.zeros_like(xt).requires_grad_(True)
        st = torch.from_numpy(sc).requires_grad_(True)
        gt, gst = (torch.from_numpy(a).to(tdt) for a in (g, gs))
        if fused:
            s, out = rk.add_rms_norm_plain(xt, rt, st)
            torch.autograd.backward((out, s), (gt, gst))
            assert torch.equal(xt.grad, rt.grad)
        else:
            rk.rms_norm_plain(xt, st).backward(gt)
        dx, dsc = rk.rms_norm_bwd_plain(xt.detach(), gt, st.detach(),
                                        gs=gst if fused else None)
        assert dx.dtype == tdt and dsc.dtype == torch.float32
        np.testing.assert_allclose(_t32(dx), _t32(xt.grad), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(dsc.numpy(), st.grad.numpy(),
                                   atol=1e-4 * max(1.0, float(
                                       st.grad.abs().max())), rtol=1e-5)

    def test_cpu_wrapper_takes_plain_path(self):
        x, sc = _rms_inputs((3, 64))
        g, _ = _rms_inputs((3, 64), seed=1)
        args = [torch.from_numpy(a) for a in (x, g, sc)]
        before = rk.rms_norm_bwd.launches
        got = rk.rms_norm_bwd(*args)
        want = rk.rms_norm_bwd_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert rk.rms_norm_bwd.launches == before == 0

    def test_cpu_autograd_runs_the_plain_forward(self):
        """On the CPU the wrappers under autograd are the plain functions:
        the same values and gradients, no launch counted."""
        x, sc = _rms_inputs((4, 96))
        r, _ = _rms_inputs((4, 96), seed=3)
        grads = []
        for fn in (ops.add_rms_norm, rk.add_rms_norm_plain):
            xt, rt, st = (torch.from_numpy(a).requires_grad_(True)
                          for a in (x, r, sc))
            s, out = fn(xt, rt, st)
            (out.square().sum() + s.sum()).backward()
            grads.append((out.detach(), xt.grad, rt.grad, st.grad))
        for a, b in zip(*grads):
            assert torch.equal(a, b)
        assert rk.rms_norm.launches == rk.rms_norm_bwd.launches == 0

    def test_bwd_rows_per_cta(self):
        assert rk.bwd_rows_per_cta(1) == rk.bwd_rows_per_cta(32) == 1
        assert rk.bwd_rows_per_cta(512) == 1
        assert rk.bwd_rows_per_cta(513) == 2
        assert rk.bwd_rows_per_cta(8192) == 16


class TestGradRefusal:
    """A kernel without a backward refuses autograd on the card
    (``kernels.grad.refuse_grad``); the condition is checked here, and the
    CPU wrappers, whose plain paths autograd differentiates, pass the
    gradient."""

    def test_wants_grad_condition(self):
        from repro_torch.kernels.grad import refuse_grad, wants_grad
        a = torch.ones(2)
        b = torch.ones(2, requires_grad=True)
        assert not wants_grad(a, None)
        assert wants_grad(a, b)
        with torch.no_grad():
            assert not wants_grad(a, b)
            refuse_grad("k", b)
        with pytest.raises(RuntimeError, match="item 14"):
            refuse_grad("k", a, b)
        refuse_grad("k", a, None)

    def test_cpu_wrappers_pass_the_gradient(self):
        q, kc, vc, lens = (torch.from_numpy(a) for a in _decode_inputs(
            2, 4, 2, 16, 24, seed=5))
        q.requires_grad_(True)
        ops.decode_attention(q, kc, vc, lens).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
        qp, kp, vp, bt, pl = (torch.from_numpy(a) for a in _paged_inputs(
            2, 4, 2, 16, 8, 3))
        kp.requires_grad_(True)
        ops.paged_decode_attention(qp, kp, vp, bt, pl,
                                   block_size=8).sum().backward()
        assert kp.grad is not None and kp.grad.abs().sum() > 0
        sq, sk, sv, la, gt = (torch.from_numpy(a) for a in _ssm_inputs(
            1, 32, 2, 8, 8))
        sv.requires_grad_(True)
        y, st = ops.ssm_chunk_scan(sq, sk, sv, la, gt, chunk=16)
        (y.sum() + st.sum()).backward()
        assert sv.grad is not None and torch.isfinite(sv.grad).all()


class TestPagedAttentionPlain:
    @pytest.mark.parametrize("case", PAGED_CASES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_matches_pallas(self, ref, case, dtype):
        jdt, tdt, tol = DTYPES[dtype]
        bs = case[4]
        q, kp, vp, bt, lens = _paged_inputs(*case)
        jnp = ref.jnp
        want = _np32(ref.paged_pallas(
            jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(lens), block_size=bs))
        got = pa.paged_decode_attention_plain(
            torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
            torch.from_numpy(lens), bs)
        live = lens >= 1
        assert got.dtype == tdt
        np.testing.assert_allclose(_t32(got)[live], want[live], atol=tol,
                                   rtol=tol)

    @pytest.mark.parametrize("case", PAGED_CASES)
    def test_ref_matches_reference_ref(self, ref, case):
        bs = case[4]
        q, kp, vp, bt, lens = _paged_inputs(*case, seed=11)
        jnp = ref.jnp
        want = np.asarray(ref.paged_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), bs))
        got = pa.paged_decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.from_numpy(lens), bs)
        np.testing.assert_allclose(_t32(got), want, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_granite34b_layout_matches_pallas(self, ref, dtype):
        """Hq=48 over one KV head: the kernel's head groups of 8 run six
        times per KV head; the plain version against the Pallas kernel."""
        jdt, tdt, tol = DTYPES[dtype]
        bs = 16
        q, kp, vp, bt, lens = _paged_inputs(2, G34["Hq"], G34["Hkv"],
                                            G34["hd"], bs, 4, seed=15)
        jnp = ref.jnp
        want = _np32(ref.paged_pallas(
            jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(bt), jnp.asarray(lens), block_size=bs))
        got = pa.paged_decode_attention_plain(
            torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
            torch.from_numpy(lens), bs)
        assert got.dtype == tdt and tuple(got.shape) == q.shape
        np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    def test_split_len_covers_whole_blocks_and_tiles(self):
        for bs_ in (1, 2, 4, 8, 16, 24, 32, 48, 64, 128):
            S = pa.split_len(bs_)
            assert S >= SPLIT and S % bs_ == 0 and S % 16 == 0
        assert pa.split_len(16) == SPLIT

    def test_zero_length_rows_are_zero(self):
        q, kp, vp, bt, lens = _paged_inputs(*PAGED_CASES[1])
        lens[1] = 0
        bt[1] = -1
        got = pa.paged_decode_attention_plain(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.from_numpy(lens), PAGED_CASES[1][4])
        assert torch.all(got[1] == 0)
        assert torch.isfinite(got).all()

    def test_cpu_wrapper_takes_plain_path(self):
        case = PAGED_CASES[0]
        q, kp, vp, bt, lens = (torch.from_numpy(a)
                               for a in _paged_inputs(*case))
        before = pa.paged_decode_attention.launches
        got = ops.paged_decode_attention(q, kp, vp, bt, lens,
                                         block_size=case[4])
        want = pa.paged_decode_attention_plain(q, kp, vp, bt, lens, case[4])
        assert torch.equal(got, want)
        assert pa.paged_decode_attention.launches == before == 0


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("case", DECODE_CASES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_matches_pallas(self, ref, case, dtype):
        jdt, tdt, tol = DTYPES[dtype]
        B, Hq, Hkv, hd, L, blk = case
        q, k, v, lens = _decode_inputs(B, Hq, Hkv, hd, L, seed=1)
        jnp = ref.jnp
        want = _np32(ref.decode_pallas(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(lens), blk_l=blk, interpret=True))
        got = da.decode_attention_plain(
            torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(lens))
        assert got.dtype == tdt
        np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    def test_length_one(self, ref):
        """Only the new token is attended: the output is its value row."""
        B, Hq, hd, L = 2, 4, 32, 64
        q, k, v, lens = _decode_inputs(B, Hq, Hq, hd, L, seed=2,
                                       lens=[1, 1])
        want = _np32(ref.decode_pallas(ref.jnp.asarray(q),
                                       ref.jnp.asarray(k),
                                       ref.jnp.asarray(v),
                                       ref.jnp.asarray(lens), blk_l=32))
        got = da.decode_attention_plain(*(torch.from_numpy(a)
                                          for a in (q, k, v, lens)))
        np.testing.assert_allclose(_t32(got), v[:, 0], atol=1e-5)
        np.testing.assert_allclose(_t32(got), want, atol=1e-5)

    @pytest.mark.parametrize("mask", MASKS, ids=[m for m, _ in MASKS])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_model_function_masks(self, ref, mask, dtype):
        """The port's models.attention.decode_attention against the
        reference's, with a sliding window and with a rolling cache whose
        lengths run past L."""
        jdt, tdt, tol = DTYPES[dtype]
        mode, window = mask
        B, Hq, Hkv, hd, L = 5, 8, 2, 64, 48
        q, k, v, _ = _decode_inputs(B, Hq, Hkv, hd, L, seed=3)
        lens = _mask_lens(mode, B, L, seed=4)
        kw = dict(sliding_window=window, rolling=mode == "rolling")
        jnp = ref.jnp
        want = _np32(ref.model_decode(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(lens), **kw))
        got = model_decode(torch.from_numpy(q).to(tdt),
                           torch.from_numpy(k).to(tdt),
                           torch.from_numpy(v).to(tdt),
                           torch.from_numpy(lens), **kw)
        np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_granite34b_layout_matches_pallas(self, ref, dtype):
        jdt, tdt, tol = DTYPES[dtype]
        q, k, v, lens = _decode_inputs(2, G34["Hq"], G34["Hkv"], G34["hd"],
                                       64, seed=16)
        jnp = ref.jnp
        want = _np32(ref.decode_pallas(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(lens), blk_l=32, interpret=True))
        got = da.decode_attention_plain(
            torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(lens))
        assert got.dtype == tdt and tuple(got.shape) == q.shape
        np.testing.assert_allclose(_t32(got), want, atol=tol, rtol=tol)

    def test_empty_span_rows_are_zero(self):
        q, k, v, lens = _decode_inputs(3, 4, 2, 32, 40, seed=5,
                                       lens=[0, 7, 40])
        got = da.decode_attention_plain(*(torch.from_numpy(a)
                                          for a in (q, k, v, lens)))
        assert torch.all(got[0] == 0) and torch.isfinite(got).all()
        assert not torch.all(got[1] == 0)

    def test_cpu_wrapper_takes_plain_path(self):
        args = [torch.from_numpy(a)
                for a in _decode_inputs(2, 4, 2, 32, 64, seed=6)]
        before = da.decode_attention.launches
        got = ops.decode_attention(*args, sliding_window=16)
        want = da.decode_attention_plain(*args, sliding_window=16)
        assert torch.equal(got, want)
        assert da.decode_attention.launches == before == 0


class TestSSMScanPlain:
    @pytest.mark.parametrize("case", SSM_CASES)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_matches_pallas(self, ref, case, dtype):
        jdt, tdt, _ = DTYPES[dtype]
        tol = SSM_TOL[dtype]
        B, S, H, dk, dv, chunk = case
        q, k, v, a, g = _ssm_inputs(B, S, H, dk, dv, seed=7)
        jnp = ref.jnp
        y0, s0 = ref.ssm_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), jnp.asarray(a),
                                jnp.asarray(g), chunk=chunk, interpret=True)
        y, s = ss.ssm_chunk_scan_plain(
            torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(a),
            torch.from_numpy(g), chunk=chunk)
        assert y.dtype == tdt and s.dtype == torch.float32
        np.testing.assert_allclose(_t32(y), _np32(y0), atol=tol, rtol=tol)
        np.testing.assert_allclose(s.numpy(), np.asarray(s0), atol=1e-3,
                                   rtol=1e-3)

    def test_ragged_pad_via_ops(self, ref):
        """ops.ssm_chunk_scan pads S=37 to the chunk of 16 with zero
        steps, as the reference's ops does."""
        q, k, v, a, g = _ssm_inputs(2, 37, 2, 8, 8, seed=8)
        jnp = ref.jnp
        y0, s0 = ref.ops.ssm_chunk_scan(*(jnp.asarray(x)
                                          for x in (q, k, v, a, g)),
                                        use_pallas=True, chunk=16)
        y, s = ops.ssm_chunk_scan(*(torch.from_numpy(x)
                                    for x in (q, k, v, a, g)), chunk=16)
        assert tuple(y.shape) == (2, 37, 2, 8)
        np.testing.assert_allclose(y.numpy(), np.asarray(y0), atol=1e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(s.numpy(), np.asarray(s0), atol=1e-3,
                                   rtol=1e-3)

    def test_cpu_wrapper_takes_plain_path(self):
        args = [torch.from_numpy(x) for x in _ssm_inputs(1, 32, 2, 8, 8)]
        before = ss.ssm_chunk_scan.launches
        y, s = ss.ssm_chunk_scan(*args, chunk=16)
        y0, s0 = ss.ssm_chunk_scan_plain(*args, chunk=16)
        assert torch.equal(y, y0) and torch.equal(s, s0)
        assert ss.ssm_chunk_scan.launches == before == 0


# (B, S, H, dk, dv, chunk) -> (padded chunk, dv tile, scores-pass and
# scan-pass shared memory a block, workspace bytes), worked out by hand
# from the layouts in csrc/ssm_scan.cu: every K5 shape of chip_smoke.py,
# zamba2-1.2b's and xlstm-350m's prefill at chunk 64 and at the models'
# chunk of 128, and the reference sweep's odd widths
SSM_PLANS = {
    (32, 64, 32, 64, 128, 64): (64, 64, 37376, 85504, 17301504),
    (32, 64, 4, 512, 513, 64): (64, 64, 37376, 200192, 2162688),
    (8, 128, 32, 64, 128, 64): (64, 64, 37376, 85504, 8650752),
    (8, 256, 4, 512, 513, 64): (64, 64, 37376, 200192, 2162688),
    (32, 256, 32, 64, 128, 128): (128, 64, 74752, 187392, 136314880),
    (32, 256, 4, 512, 513, 128): (128, 32, 74752, 220160, 17039360),
    (1, 48, 4, 32, 33, 16): (16, 64, 9344, 30592, 13824),
    (2, 40, 3, 16, 8, 40): (64, 64, 37376, 85504, 101376),
}


class TestSSMScanPlan:
    """The wrapper's launch plan, computed in Python before any launch."""

    @pytest.mark.parametrize("shape", list(SSM_PLANS))
    def test_plan_bytes(self, shape):
        p = ss.plan(*shape)
        assert tuple(p) == SSM_PLANS[shape]
        assert max(p.scores_smem, p.scan_smem) <= 232448

    @pytest.mark.parametrize("shape, match", [
        ((1, 256, 1, 2048, 8, 128), "shared memory"),
        ((1, 64, 1, 8, 8, 129), "chunk"),
        ((1, 64, 1, 8, 8, 24), "dividing S"),
        ((1, 64, 1, 8, 8, 0), "chunk"),
    ])
    def test_plan_refuses(self, shape, match):
        with pytest.raises(ValueError, match=match):
            ss.plan(*shape)

    def test_tile_narrows_only_when_needed(self):
        """dk = 512 fits the 64-wide tile at chunk 64 but not at 128, and
        the largest dk at the 32-wide tile and chunk 128 still plans."""
        assert ss.plan(1, 128, 1, 512, 64, 64).tile_v == 64
        assert ss.plan(1, 128, 1, 512, 64, 128).tile_v == 32
        assert ss.plan(1, 128, 1, 576, 64, 128).scan_smem <= 232448
        with pytest.raises(ValueError):
            ss.plan(1, 128, 1, 640, 64, 128)


class TestSwapWrapper:
    def test_cpu_wrapper_takes_plain_path(self):
        args = _swap_inputs(2, 4, 33, 3, None, seed=4)
        before = bs.swap_best.launches
        got = ops.swap_best(*args)
        want = bs.swap_best_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bs.swap_best.launches == before == 0

    def test_unbatched_is_cluster_of_one(self):
        args = _swap_inputs(1, 3, 17, 2, None, seed=5)
        v1, a1 = bs.swap_best(*(a[0] for a in args))
        vb, ab = bs.swap_best(*args)
        assert torch.equal(v1, vb[0]) and torch.equal(a1, ab[0])

    def test_other_device_raises(self):
        args = [a.to("meta") for a in _swap_inputs(1, 3, 8, 1, None)]
        with pytest.raises(ValueError):
            bs.swap_best(*args)

    @pytest.mark.parametrize("case", SWAP_CASES)
    def test_cpu_plain_equals_dense(self, case):
        """The card cases' fixtures on the CPU: the wrapper (the plain
        version) against the dense oracle, (+inf, 0) where infeasible."""
        args = _swap_inputs(*case, seed=13)
        vp, ap = bs.swap_best(*args)
        vd, ad = bs.swap_best_dense(*args)
        fin = torch.isfinite(vd)
        assert torch.equal(vp, vd) and torch.equal(ap[fin], ad[fin])
        assert torch.all(ap[~fin] == 0)
        assert bool(fin.any()) == (case[1] > 1)
        if case[4] == "one_worker":
            assert not fin[-1].any()


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each Hopper kernel against its plain version on the card."""

    @pytest.mark.parametrize("shape", RMS_SHAPES + [(32, 4096)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_rms_norm_kernel(self, cuda, shape, dtype):
        _, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs(shape, seed=7)
        xt = torch.from_numpy(x).to(cuda, tdt)
        st = torch.from_numpy(sc).to(cuda)
        before = rk.rms_norm.launches
        got = rk.rms_norm(xt, st)
        torch.cuda.synchronize()
        assert rk.rms_norm.launches == before + 1
        np.testing.assert_allclose(_t32(got), _t32(rk.rms_norm_plain(xt, st)),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("rows", NORM_ROWS)
    @pytest.mark.parametrize("width", NORM_WIDTHS)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_rms_norm_rows_and_widths(self, cuda, rows, width, dtype):
        """The norm and the fused add + norm at every path's width and at
        decode and prefill row counts, each against its plain version; the
        fused call's sum is PyTorch's and its norm bit-identical to
        ``rms_norm(x + r)`` through the kernel."""
        _, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs((rows, width), seed=rows)
        r, _ = _rms_inputs((rows, width), seed=rows + 1)
        xt = torch.from_numpy(x).to(cuda, tdt)
        rt = torch.from_numpy(r).to(cuda, tdt)
        st = torch.from_numpy(sc).to(cuda)
        s0, want_add = rk.add_rms_norm_plain(xt, rt, st)
        before = rk.rms_norm.launches
        got = rk.rms_norm(xt, st)
        s, got_add = rk.add_rms_norm(xt, rt, st)
        unfused = rk.rms_norm(s0, st)
        torch.cuda.synchronize()
        assert rk.rms_norm.launches == before + 3
        np.testing.assert_allclose(_t32(got), _t32(rk.rms_norm_plain(xt, st)),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(_t32(got_add), _t32(want_add), atol=tol,
                                   rtol=tol)
        assert torch.equal(s, s0)
        assert torch.equal(got_add, unfused)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_rms_norm_scalar_path(self, cuda, dtype):
        """A width that does not divide the 16-byte pack, a misaligned x
        and a row wider than the registers hold take the scalar kernel."""
        _, tdt, tol = DTYPES[dtype]
        for rows, width in ((7, 1001), (3, 102), (2, 20480)):
            x, sc = _rms_inputs((rows, width), seed=width)
            r, _ = _rms_inputs((rows, width), seed=width + 1)
            xt = torch.from_numpy(x).to(cuda, tdt)
            rt = torch.from_numpy(r).to(cuda, tdt)
            st = torch.from_numpy(sc).to(cuda)
            np.testing.assert_allclose(
                _t32(rk.rms_norm(xt, st)), _t32(rk.rms_norm_plain(xt, st)),
                atol=tol, rtol=tol)
            s, got = rk.add_rms_norm(xt, rt, st)
            assert torch.equal(s, xt + rt)
            assert torch.equal(got, rk.rms_norm(xt + rt, st))
        rows, width = 5, 4096
        x, sc = _rms_inputs((rows, width), seed=3)
        buf = torch.from_numpy(x).to(cuda, tdt).reshape(-1)
        buf = torch.cat([buf[:1], buf])
        xm = buf[1:].view(rows, width)             # 2 or 4 bytes off 16
        assert xm.data_ptr() % 16 != 0
        st = torch.from_numpy(sc).to(cuda)
        got = rk.rms_norm(xm, st)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_t32(got), _t32(rk.rms_norm_plain(xm, st)),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("rows,width", [(32, 4096), (8192, 4096),
                                            (7, 1024), (600, 2048),
                                            (33, 8192), (5, 1001),
                                            (3, 20480)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("fused", [False, True])
    def test_rms_norm_bwd_kernel(self, cuda, rows, width, dtype, fused):
        """The backward kernel against its plain version: dx within the
        K2 tolerance, dscale within 1e-3 of its largest entry (float32
        sums in another order); packed and scalar paths, one and many rows
        a CTA; the same bits on a second call."""
        _, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs((rows, width), seed=rows)
        g, _ = _rms_inputs((rows, width), seed=rows + 1)
        gs, _ = _rms_inputs((rows, width), seed=rows + 2)
        xt, gt, gst = (torch.from_numpy(a).to(cuda, tdt) for a in (x, g, gs))
        st = torch.from_numpy(sc).to(cuda)
        gst = gst if fused else None
        before = rk.rms_norm_bwd.launches
        dx, dsc = rk.rms_norm_bwd(xt, gt, st, gs=gst)
        dx2, dsc2 = rk.rms_norm_bwd(xt, gt, st, gs=gst)
        torch.cuda.synchronize()
        assert rk.rms_norm_bwd.launches == before + 2
        wdx, wdsc = rk.rms_norm_bwd_plain(xt, gt, st, gs=gst)
        np.testing.assert_allclose(_t32(dx), _t32(wdx), atol=tol, rtol=tol)
        scale = float(wdsc.abs().max())
        assert float((dsc - wdsc).abs().max()) <= 1e-3 * scale
        assert torch.equal(dx, dx2) and torch.equal(dsc, dsc2)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_rms_norm_autograd_on_card(self, cuda, dtype):
        """Under autograd the wrappers launch K2 forward and the backward
        kernel, and the gradients match autograd through the plain
        functions; without grad they launch K2 alone, as in serving."""
        _, tdt, tol = DTYPES[dtype]
        x, sc = _rms_inputs((64, 4096), seed=21)
        r, _ = _rms_inputs((64, 4096), seed=22)
        res = []
        for card in (True, False):
            dev = cuda if card else torch.device("cpu")
            xt, rt = (torch.from_numpy(a).to(dev, tdt).requires_grad_(True)
                      for a in (x, r))
            st = torch.from_numpy(sc).to(dev).requires_grad_(True)
            f0, b0 = rk.rms_norm.launches, rk.rms_norm_bwd.launches
            s, h = rk.add_rms_norm(xt, rt, st)
            out = rk.rms_norm(h, st)
            (out.float().square().sum() + s.float().sum()).backward()
            if card:
                torch.cuda.synchronize()
                assert rk.rms_norm.launches == f0 + 2
                assert rk.rms_norm_bwd.launches == b0 + 2
            res.append([t.detach().float().cpu() for t in
                        (out, xt.grad, rt.grad, st.grad)])
        for a, b in zip(res[0], res[1]):
            torch.testing.assert_close(a, b, atol=tol * max(
                1.0, float(b.abs().max())), rtol=tol)
        xt = torch.from_numpy(x).to(cuda, tdt)
        st = torch.from_numpy(sc).to(cuda)
        f0, b0 = rk.rms_norm.launches, rk.rms_norm_bwd.launches
        out = rk.rms_norm(xt, st)
        assert out.grad_fn is None
        assert rk.rms_norm.launches == f0 + 1
        assert rk.rms_norm_bwd.launches == b0

    def test_kernels_without_backward_refuse_grad(self, cuda):
        q, kc, vc, lens = (torch.from_numpy(a).to(cuda) for a in
                           _decode_inputs(2, 4, 2, 16, 24, seed=5))
        with pytest.raises(RuntimeError, match="item 14"):
            ops.decode_attention(q.requires_grad_(True), kc, vc, lens)
        qp, kp, vp, bt, pl = (torch.from_numpy(a).to(cuda) for a in
                              _paged_inputs(2, 4, 2, 16, 8, 3))
        with pytest.raises(RuntimeError, match="item 14"):
            ops.paged_decode_attention(qp, kp.requires_grad_(True), vp, bt,
                                       pl, block_size=8)
        torch.cuda.synchronize()

    def test_add_rms_norm_rejects_mismatched_operands(self, cuda):
        x = torch.ones((4, 64), device=cuda)
        st = torch.ones(64, device=cuda)
        with pytest.raises(ValueError):
            rk.add_rms_norm(x, x.to(torch.bfloat16), st)
        with pytest.raises(ValueError):
            rk.add_rms_norm(x, torch.ones((2, 64), device=cuda), st)

    @pytest.mark.parametrize("case", PAGED_CASES + [(32, 32, 8, 128, 16, 16),
                                      (2, 48, 1, 128, 16, 8),
                                      (3, 8, 2, 256, 16, 12)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_paged_attention_kernel(self, cuda, case, dtype):
        _, tdt, tol = DTYPES[dtype]
        bs = case[4]
        q, kp, vp, bt, lens = _paged_inputs(*case, seed=9)
        lens[0] = 0          # a bucket padding row: the kernel writes zeros
        args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp)]
        args = [a.to(tdt) for a in args] + [
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda)]
        before = pa.paged_decode_attention.launches
        got = pa.paged_decode_attention(*args, block_size=bs)
        torch.cuda.synchronize()
        assert pa.paged_decode_attention.launches == before + 1
        want = pa.paged_decode_attention_plain(*args, bs)
        np.testing.assert_allclose(_t32(got), _t32(want), atol=tol, rtol=tol)
        assert torch.all(got[0] == 0)

    @pytest.mark.parametrize("case", SWAP_CASES)
    def test_swap_kernel_bit_identical(self, cuda, case):
        args = [a.to(cuda) for a in _swap_inputs(*case, seed=13)]
        before = bs.swap_best.launches
        vk, ak = bs.swap_best(*args)
        torch.cuda.synchronize()
        assert bs.swap_best.launches == before + 1
        vp, ap = bs.swap_best_plain(*args)
        vd, ad = bs.swap_best_dense(*args)
        fin = torch.isfinite(vp)
        assert bool(fin.any()) == (case[1] > 1)
        assert torch.equal(vk, vp) and torch.equal(vk, vd)
        assert torch.equal(ak[fin], ap[fin]) and torch.equal(ak[fin],
                                                             ad[fin])
        assert torch.all(ak[~fin] == 0)       # (+inf, 0) as jnp.argmin

    def test_swap_kernel_runs_no_torch_prepass(self, cuda, monkeypatch):
        """The card's path computes the prepass inside the kernel: with
        ``swap_prep`` made to raise, the call still answers, bit for bit,
        and the profiler sees one device kernel and nothing else."""
        from torch.profiler import ProfilerActivity, profile
        args = [a.to(cuda) for a in _swap_inputs(8, 32, 512, 9, None,
                                                  seed=13)]
        vp, ap = bs.swap_best_plain(*args)
        bs.swap_best(*args)                 # built and loaded
        torch.cuda.synchronize()

        def no_prep(*_a, **_k):
            raise AssertionError("swap_prep ran on the card's path")
        monkeypatch.setattr(bs, "swap_prep", no_prep)
        for _ in range(3):        # a trace with no device activity: again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                vk, ak = bs.swap_best(*args)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                break
        fin = torch.isfinite(vp)
        assert torch.equal(vk, vp) and torch.equal(ak[fin], ap[fin])
        assert len(kernels) == 1 and "swap_best" in kernels[0].name

    @pytest.mark.parametrize("C,N", [(0, 16), (2, 0)])
    def test_swap_kernel_empty(self, cuda, C, N):
        args = [a.to(cuda) for a in _swap_inputs(max(C, 1), 3, N, 2, None)]
        args = [a[:C] for a in args]
        before = bs.swap_best.launches
        v, a = bs.swap_best(*args)
        assert v.shape == a.shape == (C, N)
        assert v.dtype == torch.float32 and a.dtype == torch.int32
        assert bs.swap_best.launches == before

    def test_swap_kernel_refuses_wide_window(self, cuda):
        W = bs._lib().swap_best_max_w(3) + 1
        args = [a.to(cuda) for a in _swap_inputs(1, 3, 8, W, None)]
        before = bs.swap_best.launches
        with pytest.raises(ValueError, match="window"):
            bs.swap_best(*args)
        assert bs.swap_best.launches == before
        vk, _ = bs.swap_best(*(a[..., :W - 1] for a in args[:2]),
                             *args[2:])
        vp, _ = bs.swap_best_plain(*(a[..., :W - 1] for a in args[:2]),
                                   *args[2:])
        assert torch.equal(vk, vp)

    def test_swap_solver_on_card_matches_cpu(self, cuda):
        from repro_torch.core.balancer_jax import bfio_assign_batch
        rng = np.random.default_rng(21)
        C, G, N, W = 3, 5, 40, 2
        base = rng.uniform(0, 10, (C, G, W)).astype(np.float32)
        caps = rng.integers(0, 12, (C, G)).astype(np.int32)
        cands = rng.uniform(0.5, 5, (C, N, W)).astype(np.float32)
        valid = rng.random((C, N)) > 0.2
        n_admit = np.minimum(valid.sum(1), caps.sum(1)).astype(np.int32)
        host = [torch.from_numpy(a) for a in (base, caps, cands, valid,
                                              n_admit)]
        want = bfio_assign_batch(*host, method="plain")
        before = bs.swap_best.launches
        got = bfio_assign_batch(*[a.to(cuda) for a in host])
        assert bs.swap_best.launches == before + 8
        assert torch.equal(got.cpu(), want)

    @pytest.mark.parametrize(
        "case", [c[:5] for c in DECODE_CASES]
        + [(32, 32, 8, 128, 256), (32, 32, 32, 64, 256), (4, 64, 8, 128, 96),
           (2, 48, 1, 128, 64), (3, 8, 2, 256, 160)])
    @pytest.mark.parametrize("mask", MASKS, ids=[m for m, _ in MASKS])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_decode_attention_kernel(self, cuda, case, mask, dtype):
        _, tdt, tol = DTYPES[dtype]
        mode, window = mask
        B, Hq, Hkv, hd, L = case
        q, k, v, _ = _decode_inputs(B, Hq, Hkv, hd, L, seed=9)
        lens = _mask_lens(mode, B, L, seed=10)
        args = [torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v)]
        args.append(torch.from_numpy(lens).to(cuda))
        kw = dict(sliding_window=window, rolling=mode == "rolling")
        before = da.decode_attention.launches
        got = da.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want = da.decode_attention_plain(*args, **kw)
        np.testing.assert_allclose(_t32(got), _t32(want), atol=tol, rtol=tol)

    def test_decode_attention_empty_rows_zero(self, cuda):
        q, k, v, lens = _decode_inputs(3, 8, 2, 64, 32, seed=11,
                                       lens=[0, 5, 32])
        args = [torch.from_numpy(x).to(cuda) for x in (q, k, v, lens)]
        got = da.decode_attention(*args)
        assert torch.all(got[0] == 0)
        np.testing.assert_allclose(
            _t32(got), _t32(da.decode_attention_plain(*args)), atol=2e-5,
            rtol=2e-5)

    def _paged_on_card(self, cuda, dtype, q, kp, vp, bt, lens, bs):
        _, tdt, tol = DTYPES[dtype]
        args = [torch.from_numpy(a).to(cuda, tdt) for a in (q, kp, vp)]
        args += [torch.from_numpy(a).to(cuda) for a in (bt, lens)]
        before = pa.paged_decode_attention.launches
        got = pa.paged_decode_attention(*args, block_size=bs)
        torch.cuda.synchronize()
        assert pa.paged_decode_attention.launches == before + 1
        want = pa.paged_decode_attention_plain(*args, bs)
        np.testing.assert_allclose(_t32(got), _t32(want), atol=tol, rtol=tol)

    def _decode_on_card(self, cuda, dtype, q, k, v, lens, **kw):
        _, tdt, tol = DTYPES[dtype]
        args = [torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v)]
        args.append(torch.from_numpy(np.asarray(lens, np.int32)).to(cuda))
        before = da.decode_attention.launches
        got = da.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want = da.decode_attention_plain(*args, **kw)
        np.testing.assert_allclose(_t32(got), _t32(want), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_paged_attention_split_boundaries(self, cuda, dtype):
        """Lengths 1, S-1, S, S+1 and L in one batch (S = 64-token split),
        each row's blocks permuted over the pool."""
        lens = [1, SPLIT - 1, SPLIT, SPLIT + 1, 256]
        self._paged_on_card(cuda, dtype,
                            *_paged_fixed(lens, 32, 8, 128, 16, 16, seed=17),
                            16)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_paged_attention_longest_row(self, cuda, dtype):
        """B=1 over 64 blocks of 16: the merge combines 16 splits, whose
        blocks lie permuted over the pool."""
        self._paged_on_card(cuda, dtype,
                            *_paged_fixed([1024], 32, 8, 128, 16, 64,
                                          seed=18), 16)

    @pytest.mark.parametrize("bs_mb", [(8, 24), (32, 6), (24, 10), (128, 3),
                                       (256, 2)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_paged_attention_other_block_sizes(self, cuda, bs_mb, dtype):
        """Blocks of 8 and 32 tokens: a split spans 8 or 2 pool blocks.
        Blocks of 24, 128 and 256 tokens: splits of 96, 128 and 256
        tokens, so a warp owns 2 to 4 tiles and refills its stage."""
        bs_, mb = bs_mb
        lens = [3, SPLIT, SPLIT + 5, bs_ * mb]
        self._paged_on_card(cuda, dtype,
                            *_paged_fixed(lens, 16, 4, 64, bs_, mb, seed=19),
                            bs_)

    def test_paged_attention_g1_hd64_bf16(self, cuda):
        lens = [5, SPLIT + 1, 192]
        self._paged_on_card(cuda, "bfloat16",
                            *_paged_fixed(lens, 8, 8, 64, 16, 12, seed=20),
                            16)

    @pytest.mark.parametrize("mask", [("causal", 0), ("window", 70)],
                             ids=["causal", "window"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_decode_attention_split_boundaries(self, cuda, mask, dtype):
        """Lengths 1, S-1, S, S+1 and L in one batch; with a window of 70
        the live span starts inside a later split."""
        mode, window = mask
        L = 256
        lens = [1, SPLIT - 1, SPLIT, SPLIT + 1, L]
        q, k, v, _ = _decode_inputs(len(lens), 32, 8, 128, L, seed=21)
        self._decode_on_card(cuda, dtype, q, k, v, lens,
                             sliding_window=window)

    @pytest.mark.parametrize("mode", ["causal", "rolling"])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_decode_attention_longest_row(self, cuda, mode, dtype):
        """B=1 over L=1024: the merge combines 16 splits."""
        L = 1024
        lens = [L] if mode == "causal" else [3 * L + 7]
        q, k, v, _ = _decode_inputs(1, 32, 8, 128, L, seed=22)
        self._decode_on_card(cuda, dtype, q, k, v, lens,
                             rolling=mode == "rolling")

    def test_decode_attention_row_of_313_splits(self, cuda):
        """L = 20000: the merge combines 313 splits of one row."""
        L = 20000
        q, k, v, _ = _decode_inputs(2, 8, 1, 128, L, seed=26)
        self._decode_on_card(cuda, "bfloat16", q, k, v, [L, 9999])

    def test_decode_attention_g1_hd64_bf16(self, cuda):
        lens = [1, SPLIT - 1, SPLIT + 1, 200]
        q, k, v, _ = _decode_inputs(len(lens), 4, 4, 64, 200, seed=23)
        self._decode_on_card(cuda, "bfloat16", q, k, v, lens)

    def test_attention_repeat_calls_agree(self, cuda):
        """Calls in a row, at two batch sizes, give the same outputs (the
        split workspace is fresh for each call)."""
        q, k, v, lens = _decode_inputs(6, 32, 8, 128, 256, seed=24)
        args = [torch.from_numpy(x).to(cuda, torch.bfloat16)
                for x in (q, k, v)] + [torch.from_numpy(lens).to(cuda)]
        first = da.decode_attention(*args)
        small = da.decode_attention(*(a[:2] for a in args))
        again = da.decode_attention(*args)
        assert torch.equal(first, again) and torch.equal(small, first[:2])
        q, kp, vp, bt, lens = _paged_inputs(*PAGED_CASES[1], seed=25)
        pargs = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, bt, lens)]
        first = pa.paged_decode_attention(*pargs, block_size=16)
        again = pa.paged_decode_attention(*pargs, block_size=16)
        assert torch.equal(first, again)

    def test_attention_rejects_bf16_hd_not_multiple_of_16(self, cuda):
        q = torch.ones((2, 4, 40), device=cuda, dtype=torch.bfloat16)
        kv = torch.ones((2, 16, 2, 40), device=cuda, dtype=torch.bfloat16)
        lens = torch.ones(2, device=cuda, dtype=torch.int32)
        with pytest.raises(ValueError, match="hd % 16"):
            da.decode_attention(q, kv, kv, lens)
        bt = torch.zeros((2, 1), device=cuda, dtype=torch.int32)
        with pytest.raises(ValueError, match="hd % 16"):
            pa.paged_decode_attention(q, kv, kv, bt, lens, block_size=16)

    def test_attention_rejects_misaligned_q(self, cuda):
        """A contiguous q 2 bytes past a 16-byte boundary: the bf16 split
        pass loads q with 16-byte copies, so the wrappers refuse it."""
        buf = torch.zeros(2 * 4 * 64 + 1, device=cuda, dtype=torch.bfloat16)
        q = buf[1:].view(2, 4, 64)
        assert q.is_contiguous() and q.data_ptr() % 16
        kv = torch.ones((2, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
        lens = torch.ones(2, device=cuda, dtype=torch.int32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            da.decode_attention(q, kv, kv, lens)
        bt = torch.zeros((2, 1), device=cuda, dtype=torch.int32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            pa.paged_decode_attention(q, kv, kv, bt, lens, block_size=16)

    @pytest.mark.parametrize(
        "case", SSM_CASES + [(32, 64, 32, 64, 128, 64),
                             (4, 64, 4, 512, 513, 64),
                             (2, 256, 4, 512, 513, 128)])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("init", [False, True])
    def test_ssm_scan_kernel(self, cuda, case, dtype, init):
        _, tdt, _ = DTYPES[dtype]
        tol = SSM_TOL[dtype]
        B, S, H, dk, dv, chunk = case
        q, k, v, a, g = _ssm_inputs(B, S, H, dk, dv, seed=12)
        args = [torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v)]
        args += [torch.from_numpy(x).to(cuda) for x in (a, g)]
        s0 = None
        if init:
            s0 = 0.1 * torch.randn((B, H, dk, dv), device=cuda,
                                   generator=torch.Generator(cuda)
                                   .manual_seed(13))
        before = ss.ssm_chunk_scan.launches
        y, s = ss.ssm_chunk_scan(*args, chunk=chunk, initial_state=s0)
        torch.cuda.synchronize()
        assert ss.ssm_chunk_scan.launches == before + 1
        y0, st0 = ss.ssm_chunk_scan_plain(*args, chunk=chunk,
                                          initial_state=s0)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=tol, rtol=tol)
        np.testing.assert_allclose(_t32(s), _t32(st0), atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("case", SSM_BWD_CASES)
    def test_ssm_bwd_kernel(self, cuda, case):
        """K5's backward kernel against its plain version, every gradient
        within SSM_TOL's float32 1e-3 of its largest entry; a second call
        repeats the first bit for bit (no atomics: every sum in a fixed
        order)."""
        args, s0, dy, ds = self._ssm_bwd_on_card(cuda, case)
        chunk = case[5]
        before = ss.ssm_chunk_scan_bwd.launches
        got = ss.ssm_chunk_scan_bwd(*args, dy, ds, chunk=chunk,
                                    initial_state=s0)
        again = ss.ssm_chunk_scan_bwd(*args, dy, ds, chunk=chunk,
                                      initial_state=s0)
        torch.cuda.synchronize()
        assert ss.ssm_chunk_scan_bwd.launches == before + 2
        want = ss.ssm_chunk_scan_bwd_plain(*args, dy, ds, chunk=chunk,
                                           initial_state=s0)
        assert (got[5] is None) == (not case[6])
        for name, x, x2, w in zip(("dq", "dk", "dv", "da", "dg", "ds0"),
                                  got, again, want):
            if w is None:
                continue
            assert torch.equal(x, x2), name
            err = float((x - w).abs().max() / w.abs().max())
            assert err <= SSM_TOL["float32"], (name, err)

    @pytest.mark.parametrize("case", SSM_BWD_CASES)
    def test_ssm_bwd_launches_its_plan(self, cuda, case):
        """A call runs exactly the plan's device kernels (one a pass), as
        the profiler sees them."""
        from torch.profiler import ProfilerActivity, profile
        args, s0, dy, ds = self._ssm_bwd_on_card(cuda, case)
        B, S, H, dk, dv, chunk = case[:6]
        ss.ssm_chunk_scan_bwd(*args, dy, ds, chunk=chunk, initial_state=s0)
        torch.cuda.synchronize()
        one = torch.zeros(1, device=cuda)
        for _ in range(3):        # a trace with no device activity: again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # a trace can miss its first device kernel: one before
                one.add_(1)
                torch.cuda.synchronize()
                ss.ssm_chunk_scan_bwd(*args, dy, ds, chunk=chunk,
                                      initial_state=s0)
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                break
        p = ss.plan(B, S, H, dk, dv, chunk, backward=True)
        ours = [k for k in kernels if "ssm_bwd" in k]
        assert len(ours) == p.launches == len(ss.BWD_PASSES), kernels
        assert len(kernels) - len(ours) <= 1, kernels

    def _ssm_bwd_on_card(self, cuda, case):
        B, S, H, dk, dv, chunk, init, dstate = case[:8]
        args, s0 = self._ssm_on_card(cuda, (B, S, H, dk, dv, chunk), 21,
                                     0.1 if init else None)
        if case[8:] == ("decay",):
            args[3] = 2.0 * args[3] - 1.0
            assert float(args[3].max()) <= -1.0
        gen = torch.Generator(cuda).manual_seed(22)
        dy = torch.randn((B, S, H, dv), device=cuda, generator=gen)
        ds = (torch.randn((B, H, dk, dv), device=cuda, generator=gen)
              if dstate else None)
        return args, s0, dy, ds

    def test_ssm_grad_through_the_kernel(self, cuda):
        """Autograd on the card through K5's Function, against autograd of
        the plain version on the CPU, at the models' chunk of 128 over a
        ragged S (ops pads it)."""
        B, S, H, dk, dv = 2, 200, 3, 32, 48
        xs = _ssm_inputs(B, S, H, dk, dv, seed=23)
        grads = []
        before = ss.ssm_chunk_scan_bwd.launches
        for dev in ("cpu", cuda):
            args = [torch.from_numpy(x).to(dev).requires_grad_(True)
                    for x in xs]
            y, st = ops.ssm_chunk_scan(*args, chunk=128)
            (y.square().sum() + st.sum()).backward()
            grads.append([a.grad.cpu() for a in args])
        assert ss.ssm_chunk_scan_bwd.launches == before + 1
        for g_cpu, g_card in zip(*grads):
            err = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
            assert err <= SSM_TOL["float32"], err

    def test_ssm_bf16_grad_refused(self, cuda):
        sq, sk, sv, la, gt = (torch.from_numpy(a).to(cuda) for a in
                              _ssm_inputs(1, 32, 2, 8, 8))
        with pytest.raises(TypeError, match="float32"):
            ss.ssm_chunk_scan(sq.bfloat16(), sk.bfloat16(),
                              sv.bfloat16().requires_grad_(True), la, gt,
                              chunk=16)

    @pytest.mark.parametrize("case", SSM_BWD_CASES)
    def test_ssm_bwd_plan_matches_kernel(self, cuda, case):
        B, S, H, dk, dv, chunk = case[:6]
        p = ss.plan(B, S, H, dk, dv, chunk, backward=True)
        fn = ss._lib().ssm_scan_bwd_plan_bytes
        assert tuple(fn(chunk, which) for which in range(4)) == p.smem
        assert 4 * fn(chunk, 4) * B * H * (S // chunk) == p.record_bytes

    def _ssm_on_card(self, cuda, case, seed, init_scale=None):
        B, S, H, dk, dv, chunk = case
        args = [torch.from_numpy(x).to(cuda)
                for x in _ssm_inputs(B, S, H, dk, dv, seed=seed)]
        s0 = None
        if init_scale is not None:
            s0 = init_scale * torch.randn(
                (B, H, dk, dv), device=cuda,
                generator=torch.Generator(cuda).manual_seed(seed))
        return args, s0

    def test_ssm_zero_state_equals_no_state(self, cuda):
        """A state of zeros takes the full path (the skip is keyed on the
        pointer), and gives exactly the no-state result."""
        args, z = self._ssm_on_card(cuda, (2, 192, 4, 64, 129, 64), 15, 0.0)
        y0, s0 = ss.ssm_chunk_scan(*args, chunk=64)
        y1, s1 = ss.ssm_chunk_scan(*args, chunk=64, initial_state=z)
        torch.cuda.synchronize()
        assert torch.equal(y0, y1) and torch.equal(s0, s1)

    @pytest.mark.parametrize("case", [(2, 256, 4, 512, 513, 64),
                                      (8, 256, 4, 512, 513, 64)])
    def test_ssm_nonzero_state_over_chunks(self, cuda, case):
        """A nonzero state over four chunks at xlstm's widths: the
        products with the state run, and differ from the no-state call."""
        args, s0 = self._ssm_on_card(cuda, case, 16, 0.1)
        y, s = ss.ssm_chunk_scan(*args, chunk=64, initial_state=s0)
        y0, st0 = ss.ssm_chunk_scan_plain(*args, chunk=64, initial_state=s0)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(st0), atol=1e-3, rtol=1e-3)
        yz, _ = ss.ssm_chunk_scan(*args, chunk=64)
        assert (y[:, :64] - yz[:, :64]).abs().max().item() > 1e-2

    @pytest.mark.parametrize("case", [(32, 256, 32, 64, 128, 128),
                                      (32, 256, 4, 512, 513, 128)])
    def test_ssm_models_chunk_128(self, cuda, case):
        """Both families' widths at the chunk of 128 the models pass for a
        prefill of 128 tokens or more; xlstm's widths take the 32-wide dv
        tile there without a monkeypatch."""
        args, _ = self._ssm_on_card(cuda, case, 21)
        y, s = ss.ssm_chunk_scan(*args, chunk=case[-1])
        y0, st0 = ss.ssm_chunk_scan_plain(*args, chunk=case[-1])
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(st0), atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("case", [(2, 128, 3, 64, 100, 64),
                                      (3, 64, 2, 96, 70, 32),
                                      (2, 96, 2, 40, 65, 48)])
    @pytest.mark.parametrize("init", [False, True])
    def test_ssm_ragged_widths(self, cuda, case, init):
        """dv not a multiple of the dv tile, dk not a multiple of the
        64-row slab, a chunk that is not a template size."""
        args, s0 = self._ssm_on_card(cuda, case, 17, 0.1 if init else None)
        y, s = ss.ssm_chunk_scan(*args, chunk=case[-1], initial_state=s0)
        y0, st0 = ss.ssm_chunk_scan_plain(*args, chunk=case[-1],
                                          initial_state=s0)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(st0), atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("S", [1, 40, 63])
    def test_ssm_one_short_chunk_via_ops(self, cuda, S):
        """S < chunk: ops.ssm_chunk_scan pads to one chunk of 64."""
        args, _ = self._ssm_on_card(cuda, (4, S, 32, 64, 128, 64), 18)
        y, s = ops.ssm_chunk_scan(*args, chunk=64)
        y0, s0 = ops.ssm_chunk_scan(*[a.cpu() for a in args], chunk=64)
        assert tuple(y.shape) == (4, S, 32, 128)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(s0), atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("init", [False, True])
    def test_ssm_narrow_tile(self, cuda, monkeypatch, init):
        """The 32-wide dv tile, which only wide states take on their own,
        at zamba2's widths."""
        monkeypatch.setattr(ss, "TILES_V", (32,))
        args, s0 = self._ssm_on_card(cuda, (2, 128, 4, 64, 128, 64), 19,
                                     0.1 if init else None)
        assert ss.plan(2, 128, 4, 64, 128, 64).tile_v == 32
        y, s = ss.ssm_chunk_scan(*args, chunk=64, initial_state=s0)
        y0, st0 = ss.ssm_chunk_scan_plain(*args, chunk=64, initial_state=s0)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(st0), atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("shape", list(SSM_PLANS))
    def test_ssm_plan_matches_kernel(self, cuda, shape):
        """The Python plan and the launcher's own sizes agree."""
        B, S, H, dk, dv, chunk = shape
        p = ss.plan(*shape)
        fn = ss._lib().ssm_scan_plan_bytes
        assert fn(chunk, dk, p.tile_v, 0) == p.scores_smem
        assert fn(chunk, dk, p.tile_v, 1) == p.scan_smem
        assert 4 * fn(chunk, dk, p.tile_v, 2) * B * H * (S // chunk) \
            == p.workspace_bytes

    def test_ssm_refuses_before_launch(self, cuda):
        z = torch.zeros((1, 128, 1, 2048), device=cuda)
        v = torch.zeros((1, 128, 1, 8), device=cuda)
        a = torch.zeros((1, 128, 1), device=cuda)
        before = ss.ssm_chunk_scan.launches
        with pytest.raises(ValueError, match="shared memory"):
            ss.ssm_chunk_scan(z, z, v, a, a, chunk=128)
        assert ss.ssm_chunk_scan.launches == before

    def test_ssm_scores_pass_alone(self, cuda):
        """The scores pass's record: W, exp(clip(A)) and the state-update
        weights of each chunk, against the plain formulas."""
        B, S, H, dk, dv, C = 2, 128, 3, 64, 16, 64
        args, _ = self._ssm_on_card(cuda, (B, S, H, dk, dv, C), 20)
        q, k, _, a, g = args
        q, k, _, a, g = args
        ws = ss.scores_pass(q, k, a, g, chunk=C).view(B, H, S // C,
                                                      C * C + 2 * C)
        n = S // C
        qc = q.view(B, n, C, H, dk).permute(0, 3, 1, 2, 4)
        kc = k.view(B, n, C, H, dk).permute(0, 3, 1, 2, 4)
        A = torch.cumsum(a.view(B, n, C, H).permute(0, 3, 1, 2), dim=-1)
        gc = g.view(B, n, C, H).permute(0, 3, 1, 2)
        W = (qc @ kc.transpose(-1, -2)) \
            * torch.tril(ss._exp_clip(A[..., :, None] - A[..., None, :])) \
            * gc[..., None, :]
        wk = ss._exp_clip(A[..., -1:] - A) * gc
        for got, want in ((ws[..., :C * C].view(B, H, n, C, C), W),
                          (ws[..., C * C:C * C + C], ss._exp_clip(A)),
                          (ws[..., C * C + C:], wk)):
            np.testing.assert_allclose(_t32(got), _t32(want), atol=1e-3,
                                       rtol=1e-3)

    def test_ssm_cumsum_in_plain_order(self, cuda):
        """The scores pass sums A = cumsum(a) left to right, as the plain
        version's ``torch.cumsum`` does, so exp(clip(A)) agrees to an ulp
        or two.  A parallel scan rounds A differently: at chunk 128 |A|
        reaches ~100, a few ulps of A are ~1e-5 of exp(A), and that moved
        y past the 1e-3 gate where a row cancels."""
        B, S, H, dk, C = 4, 256, 32, 64, 128
        args, _ = self._ssm_on_card(cuda, (B, S, H, dk, 8, C), 22)
        q, k, _, a, g = args
        ws = ss.scores_pass(q, k, a, g, chunk=C).view(B, H, S // C,
                                                      C * C + 2 * C)
        A = torch.cumsum(a.view(B, S // C, C, H), dim=2).permute(0, 3, 1, 2)
        np.testing.assert_allclose(_t32(ws[..., C * C:C * C + C]),
                                   _t32(ss._exp_clip(A)), rtol=2e-6, atol=0)

    def test_ssm_ragged_pad_on_card(self, cuda):
        args = [torch.from_numpy(x).to(cuda)
                for x in _ssm_inputs(3, 100, 4, 64, 129, seed=14)]
        y, s = ops.ssm_chunk_scan(*args, chunk=64)
        cpu = [a.cpu() for a in args]
        y0, s0 = ops.ssm_chunk_scan(*cpu, chunk=64)
        np.testing.assert_allclose(_t32(y), _t32(y0), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_t32(s), _t32(s0), atol=1e-3, rtol=1e-3)

    def test_kernel_rejects_bad_input(self, cuda):
        x = torch.ones((4, 64), device=cuda, dtype=torch.float16)
        with pytest.raises(TypeError):
            rk.rms_norm(x, torch.ones(64, device=cuda))
        q = torch.ones((2, 4, 64), device=cuda)
        kv = torch.ones((2, 16, 2, 64), device=cuda)
        with pytest.raises(TypeError):      # lengths must be int32
            da.decode_attention(q, kv, kv, torch.ones(2, device=cuda,
                                                      dtype=torch.int64))
        z = torch.zeros((1, 32, 1, 8), device=cuda)
        a = torch.zeros((1, 32, 1), device=cuda)
        with pytest.raises(ValueError):     # S not a multiple of chunk
            ss.ssm_chunk_scan(z, z, z, a, a, chunk=24)
