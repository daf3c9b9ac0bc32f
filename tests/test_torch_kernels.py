"""The port's kernels (repro_torch.kernels) against the reference's
Pallas kernels and jnp functions.

On the CPU each wrapper runs its plain PyTorch version, which is held
against ``rms_norm_pallas`` / ``paged_decode_attention_pallas`` in
interpret mode and against the reference's own oracles, on the same
inputs drawn from a numpy seed.  Tolerances are the reference's kernel
tolerances (``tests/test_kernels.py``): float32 2e-5, bfloat16 2e-2.
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
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rms_norm as rk

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


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernels and oracles (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.paged_attention import paged_decode_attention_pallas
    from repro.kernels.rms_norm import rms_norm_pallas
    from repro.models.layers import rms_norm
    from repro.serving.paged_cache import paged_decode_attention_ref
    return types.SimpleNamespace(
        jnp=jnp, rms_norm_pallas=rms_norm_pallas, model_rms_norm=rms_norm,
        paged_pallas=paged_decode_attention_pallas,
        paged_ref=paged_decode_attention_ref)


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

    def test_kernel_rejects_bad_input(self, cuda):
        x = torch.ones((4, 64), device=cuda, dtype=torch.float16)
        with pytest.raises(TypeError):
            rk.rms_norm(x, torch.ones(64, device=cuda))
