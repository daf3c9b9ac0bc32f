"""K5's backward (``repro_torch.kernels.ssm_scan.ssm_chunk_scan_bwd``) on
the CPU.

On a CPU tensor the wrapper runs ``ssm_chunk_scan_bwd_plain``, the
gradient of the chunked form written out (the reverse recursion over
chunks), which is the backward kernel's yardstick on the card.  It is
held against autograd of ``ssm_chunk_scan_plain`` and against
``jax.grad`` of the reference's ``models/ssm.chunked_linear_attention``
on the same numpy-seeded inputs: with and without an initial state, with
and without a gradient of the final state, at every padded chunk of the
kernel (16 to 128) and at xlstm's value width with its normalizer
column (dv 513).  Every gradient is held within ``SSM_TOL``'s float32
1e-3 of its largest entry (the reference's scan tolerance,
``tests/test_kernels.py``).  The kernel itself is held against the plain
version by the ``cuda`` cases of ``tests/test_torch_kernels.py``.
"""
import warnings

warnings.filterwarnings("ignore")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import chunked_linear_attention as ref_scan
from repro_torch.kernels import ssm_scan as ss

TOL = 1e-3
NAMES = ("dq", "dk", "dv", "d(log_decay)", "d(gate)", "d(initial_state)")
# (B, S, H, dk, dv, chunk, initial state, final-state gradient)
CASES = [(2, 64, 3, 8, 5, 16, False, False),
         (2, 64, 3, 8, 5, 16, True, True),
         (1, 96, 2, 16, 12, 32, False, True),
         (2, 128, 2, 16, 24, 64, True, False),
         (1, 256, 2, 8, 16, 128, True, True),
         (1, 256, 2, 8, 513, 128, False, True),
         (1, 128, 1, 4, 513, 64, True, False),
         (2, 80, 2, 8, 12, 40, True, True)]


def _inputs(B, S, H, dk, dv, init, dstate, seed=0):
    """The reference's fixture (a <= 0, g >= 0), an initial state, y's
    gradient and the final state's."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    x = (n(B, S, H, dk), n(B, S, H, dk), n(B, S, H, dv),
         -np.abs(n(B, S, H)), np.abs(n(B, S, H)))
    s0 = n(B, H, dk, dv, scale=0.1) if init else None
    return x, s0, n(B, S, H, dv), (n(B, H, dk, dv) if dstate else None)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * scale, f"{what}: max err {err:.3e}, scale {scale:.3e}"


def _plain(case):
    B, S, H, dk, dv, chunk, init, dstate = case
    x, s0, dy, ds = _inputs(B, S, H, dk, dv, init, dstate)
    t = torch.from_numpy
    got = ss.ssm_chunk_scan_bwd_plain(
        *(t(a) for a in x), t(dy), None if ds is None else t(ds),
        chunk=chunk, initial_state=None if s0 is None else t(s0))
    return got, (x, s0, dy, ds)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_autograd(case):
    chunk = case[5]
    got, (x, s0, dy, ds) = _plain(case)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in x]
    st0 = None if s0 is None else torch.from_numpy(s0).requires_grad_(True)
    y, st = ss.ssm_chunk_scan_plain(*ins, chunk=chunk, initial_state=st0)
    loss = (y * torch.from_numpy(dy)).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    want = torch.autograd.grad(loss, ins + ([st0] if st0 is not None
                                            else []))
    assert (got[5] is None) == (s0 is None)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_grad(case):
    """jax.grad of the reference's model function on the same inputs."""
    chunk = case[5]
    got, (x, s0, dy, ds) = _plain(case)

    def loss(q, k, v, a, g, s):
        y, st = ref_scan(q, k, v, a, g, chunk=chunk, initial_state=s)
        out = jnp.sum(y * dy)
        if ds is not None:
            out = out + jnp.sum(st * ds)
        return out

    args = [jnp.asarray(a) for a in x] + [
        None if s0 is None else jnp.asarray(s0)]
    argnums = (0, 1, 2, 3, 4) + ((5,) if s0 is not None else ())
    want = jax.jit(jax.grad(loss, argnums=argnums))(*args)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w, name)


def test_cpu_wrapper_takes_plain_path():
    case = CASES[1]
    want, (x, s0, dy, ds) = _plain(case)
    t = torch.from_numpy
    before = ss.ssm_chunk_scan_bwd.launches
    got = ss.ssm_chunk_scan_bwd(*(t(a) for a in x), t(dy), t(ds),
                                chunk=case[5], initial_state=t(s0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ss.ssm_chunk_scan_bwd.launches == before == 0


def test_grad_mode_on_cpu_is_autograd_of_plain():
    """On the CPU the forward wrapper's gradient is autograd's through the
    plain version: the same gradient as the plain backward's."""
    case = (1, 64, 2, 8, 8, 16, False, False)
    got, (x, _, dy, _) = _plain(case)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in x]
    y, _ = ss.ssm_chunk_scan(*ins, chunk=16)
    assert y.grad_fn is not None
    want = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), ins)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), name)


# (B, S, H, dk, dv, chunk) -> (dk tiles, dv tiles, shared memory a block
# of the record, state-products, dq/dk and dv passes, the chunks' records,
# the states and state gradients of every chunk, the dk tiles' parts of
# the per-step scalars; bytes), from the layouts in csrc/ssm_scan.cu
# (bwd_*_smem, bwd_record_floats): zamba2's train shape, xlstm's widths,
# the smallest chunk
BWD_PLANS = {
    (2, 4096, 32, 64, 128, 128): (1, 2, (112128, 35840, 38432, 29696),
                                  274726912, 134217728, 2105344),
    (1, 256, 4, 512, 513, 128): (8, 9, (112128, 35840, 38432, 29696),
                                 1073152, 16809984, 65792),
    (1, 32, 1, 8, 8, 16): (1, 1, (10432, 34944, 20064, 11328), 4864, 1024,
                           264),
}


class TestBwdPlan:
    @pytest.mark.parametrize("shape", list(BWD_PLANS))
    def test_plan_bytes(self, shape):
        p = ss.plan(*shape, backward=True)
        assert isinstance(p, ss.BwdPlan)
        assert p.fwd == ss.plan(*shape)
        assert tuple(p)[1:-1] == BWD_PLANS[shape]
        assert p.launches == len(ss.BWD_PASSES) == 6
        assert max(p.smem) <= 232448

    def test_tiles_cover_the_state(self):
        """dq/dk blocks take 64-wide dk tiles and dv blocks 64-wide dv
        tiles, so each output element has one block; at zamba2's widths
        two blocks of every pass fit an SM's 228 KB of shared memory, and
        the workspace stays under the 749.7 MB the per-dv-tile design
        took at zamba2's train shape."""
        p = ss.plan(1, 64, 1, 65, 129, 64, backward=True)
        assert (p.dk_tiles, p.dv_tiles) == (2, 3)
        p = ss.plan(2, 4096, 32, 64, 128, 128, backward=True)
        assert all(2 * (sm + 1024) <= 233472 for sm in p.smem)
        assert p.record_bytes + p.states_bytes + p.parts_bytes <= 749.7e6

    def test_refuses_what_does_not_fit(self):
        """A shape the forward refuses is refused first (its scan block's
        shared memory, the chunk); the backward refuses a grid it cannot
        launch, before anything is allocated."""
        with pytest.raises(ValueError, match="shared memory"):
            ss.plan(1, 128, 1, 2048, 8, 128, backward=True)
        with pytest.raises(ValueError, match="chunk"):
            ss.plan(1, 64, 1, 8, 8, 129, backward=True)
        assert ss.plan(2 ** 31, 16, 1, 8, 8, 16).cp == 16
        with pytest.raises(ValueError, match="backward kernel"):
            ss.plan(2 ** 31, 16, 1, 8, 8, 16, backward=True)
