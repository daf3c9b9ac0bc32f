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


# (B, S, H, dk, dv, chunk) -> (backward dv tile, tiles, shared memory a
# block, backward records, chunk states, tiles' parts; bytes), from the
# layouts in csrc/ssm_scan.cu (bwd_smem, bwd_record_floats): zamba2's
# train shape, xlstm's widths, the smallest chunk
BWD_PLANS = {
    (2, 4096, 32, 64, 128, 128): (32, 4, 206728, 137363456, 67108864,
                                  545259520),
    (1, 256, 4, 512, 513, 128): (16, 33, 215688, 536576, 8404992,
                                 138682368),
    (1, 32, 1, 8, 8, 16): (16, 1, 10376, 2432, 512, 2304),
}


class TestBwdPlan:
    @pytest.mark.parametrize("shape", list(BWD_PLANS))
    def test_plan_bytes(self, shape):
        p = ss.plan(*shape, backward=True)
        assert isinstance(p, ss.BwdPlan)
        assert p.fwd == ss.plan(*shape)
        assert tuple(p)[1:] == BWD_PLANS[shape]
        assert p.bwd_smem <= 232448

    def test_tile_never_wider_than_the_chunk(self):
        """The k dS accumulator reuses a chunk-wide buffer, so the tile is
        at most the padded chunk."""
        assert ss.plan(1, 32, 1, 8, 64, 16, backward=True).tile_b == 16
        assert ss.plan(1, 64, 1, 8, 64, 32, backward=True).tile_b == 32
        assert ss.plan(1, 64, 1, 8, 64, 64, backward=True).tile_b == 64

    def test_refuses_what_does_not_fit(self, monkeypatch):
        """The backward's block needs less shared memory than the forward's
        scan block at every chunk, so a shape the forward refuses is the
        first refusal; with the 64-wide tile alone, xlstm's dk = 512 at
        chunk 128 does not fit the backward, which says so."""
        with pytest.raises(ValueError, match="shared memory"):
            ss.plan(1, 128, 1, 2048, 8, 128, backward=True)
        with pytest.raises(ValueError, match="chunk"):
            ss.plan(1, 64, 1, 8, 8, 129, backward=True)
        monkeypatch.setattr(ss, "TILES_B", (64,))
        assert ss.plan(1, 128, 1, 512, 513, 128).tile_v == 32
        with pytest.raises(ValueError, match="backward"):
            ss.plan(1, 128, 1, 512, 513, 128, backward=True)
