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
PAGED_CASES = [(2, 4, 2, 32, 8, 4), (3, 8, 4, 64, 16, 5),
               (1, 16, 2, 128, 32, 3)]
# (C, G, N, W, n_valid): the chip smoke's two shapes (the router's bucket
# with integer loads, pod scale with random floats), N below the kernel's
# 64-row tile, and ragged tiles
SWAP_CASES = [(1, 4, 64, 1, 24), (8, 32, 512, 9, None), (1, 3, 17, 2, None),
              (3, 4, 33, 3, None), (2, 5, 130, 4, 100)]
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
# sliding window / rolling cases of the model function: (mode, window)
MASKS = [("causal", 0), ("window", 24), ("rolling", 24)]


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


def _swap_inputs(C, G, N, W, n_valid, seed=0):
    """With ``n_valid``: integer loads and sizes, the first rows valid
    (the router's padded bucket); without: random floats, ragged
    ``valid``, ``assign`` with -1s (the reference's fixtures)."""
    rng = np.random.default_rng(seed)
    if n_valid is not None:
        loads = rng.integers(0, 2048, (C, G, W)).astype(np.float32)
        cands = rng.integers(2, 256, (C, N, W)).astype(np.float32)
        valid = np.zeros((C, N), bool)
        valid[:, :n_valid] = True
        assign = np.where(valid, rng.integers(0, G, (C, N)), -1)
    else:
        loads = rng.uniform(0, 10, (C, G, W)).astype(np.float32)
        cands = rng.uniform(0, 5, (C, N, W)).astype(np.float32)
        assign = rng.integers(-1, G, (C, N))
        valid = rng.random((C, N)) > 0.1
    return [torch.from_numpy(a) for a in (loads, cands,
                                          assign.astype(np.int32), valid)]


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

    @pytest.mark.parametrize("case", PAGED_CASES + [(32, 32, 8, 128, 16, 16)])
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
        assert fin.any()
        assert torch.equal(vk, vp) and torch.equal(vk, vd)
        assert torch.equal(ak[fin], ap[fin]) and torch.equal(ak[fin],
                                                             ad[fin])
        assert torch.all(ak[~fin] == 0)       # (+inf, 0) as jnp.argmin

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
        + [(32, 32, 8, 128, 256), (32, 32, 32, 64, 256), (4, 64, 8, 128, 96)])
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
