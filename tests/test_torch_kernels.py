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

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rms_norm as rk

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RMS_SHAPES = [(4, 32), (2, 7, 96), (1, 128), (5, 3, 2, 64)]
PAGED_CASES = [(2, 4, 2, 32, 8, 4), (3, 8, 4, 64, 16, 5),
               (1, 16, 2, 128, 32, 3)]
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

    def test_kernel_rejects_bad_input(self, cuda):
        x = torch.ones((4, 64), device=cuda, dtype=torch.float16)
        with pytest.raises(TypeError):
            rk.rms_norm(x, torch.ones(64, device=cuda))
