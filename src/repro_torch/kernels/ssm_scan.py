"""Chunked gated linear-attention scan (the Mamba2 SSD / mLSTM inner loop).

    S_t = exp(a_t) * S_{t-1} + g_t * k_t v_t^T        (state: dk x dv, fp32)
    y_t = q_t . S_t

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py:
ssm_chunk_scan_pallas``, with an optional initial state (the reference's
model function ``models/ssm.chunked_linear_attention`` takes one, the
Pallas kernel does not).  Per chunk of C steps, with A = cumsum(a):

    y      = (tril(exp(clip(A_t - A_s))) * g_s * (q k^T)) v
             + exp(clip(A_t)) * (q . S_prev)
    S_new  = exp(clip(A_C)) * S_prev + sum_s exp(clip(A_C - A_s)) g_s k_s v_s^T

with every exponent clipped to +-60 before ``exp``.

On an H100 the kernel (``csrc/ssm_scan.cu``) is bound by its float32
operations at the model's shapes (the intra-chunk C x C form and the
(dk x dv) state products; at xlstm's dk = 512 they outweigh the bytes).
It runs as two passes from one call.  The scores pass, one block per
(b, h, chunk), forms A = cumsum(a) and the masked decay-weighted scores
W = tril(exp(clip(A_t - A_s))) g_s (q k^T) once per chunk and writes them,
with exp(clip(A_t)) and the state-update weights, to a workspace this
wrapper allocates.  The scan pass, one block per (b, h, dv tile), keeps a
(dk x tile) fp32 state slice in shared memory and walks the chunks in
order; every product in it is register-tiled.  With no initial state the
first chunk skips the products with the zero state.  :func:`plan` sizes
both passes before any launch and refuses what does not fit.

:func:`ssm_chunk_scan` is the wrapper: on a CPU tensor it runs
:func:`ssm_chunk_scan_plain`; on a CUDA tensor it launches both passes or
raises.  ``ssm_chunk_scan.launches`` counts calls that launched them.
On DTensors (a model under a mesh) :func:`on_shards` runs a scan on each
local shard with the batch rows as v shards them and the time axis, the
heads and the state dims whole.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .grad import refuse_grad
from .sharded import as_dtensor, is_dtensor, kept
from .sharded import on_shards as _on_shards

__all__ = ["ssm_chunk_scan", "ssm_chunk_scan_plain", "plan", "Plan",
           "scores_pass"]

CLIP = 60.0
TILES_V = (64, 32)   # the scan pass's dv tile, the widest that fits first
_SLAB_SCORES = 32    # dk columns a scores-pass slab
_SLAB_SCAN = 64      # dk columns a scan-pass slab
_SMEM_MAX = 232448   # the H100's shared memory per block, in bytes
_GRID_Y_MAX = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _exp_clip(x):
    return torch.exp(torch.clamp(x, -CLIP, CLIP))


def ssm_chunk_scan_plain(q, k, v, log_decay, gate, *, chunk: int,
                         initial_state: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel, and the port's CPU path: the
    reference's chunk-parallel form (``models/ssm.chunked_linear_attention``
    after its padding and broadcasts), all chunks' intra-chunk terms at
    once, then a loop over chunks carrying the state.

    q, k: (B, S, H, dk); v: (B, S, H, dv); log_decay, gate: (B, S, H);
    S a multiple of ``chunk``; initial_state: (B, H, dk, dv) or None
    (zeros).  Returns (y (B, S, H, dv) in v's dtype, final state (B, H,
    dk, dv) float32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    assert S % chunk == 0, (S, chunk)
    n = S // chunk

    def c(x):
        return x.float().reshape((B, n, chunk) + tuple(x.shape[2:]))

    qc, kc, vc, ac, gc = c(q), c(k), c(v), c(log_decay), c(gate)
    A = torch.cumsum(ac, dim=2)                       # (B, n, C, H)
    A_tot = A[:, :, -1]                               # (B, n, H)
    tri = torch.tril(torch.ones((chunk, chunk), device=q.device))
    scores = torch.einsum("bnchd,bnshd->bnhcs", qc, kc)
    At = A.permute(0, 1, 3, 2)                        # (B, n, H, C)
    decay = _exp_clip(At[..., :, None] - At[..., None, :]) * tri
    gates = gc.permute(0, 1, 3, 2)                    # (B, n, H, C)
    w = scores * decay * gates[..., None, :]
    y_intra = torch.einsum("bnhcs,bnshd->bnchd", w, vc)
    wk = _exp_clip(A_tot[:, :, None, :] - A) * gc    # (B, n, C, H)
    # k * wk first: a three-operand einsum contracted left to right would
    # materialise a (B, n, C, H, dk, dv) outer product
    U = torch.einsum("bnchk,bnchv->bnhkv", kc * wk[..., None], vc)
    if initial_state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                            device=q.device)
    else:
        state = initial_state.float()
    y_inter = []
    for i in range(n):
        y_inter.append(torch.einsum("bchk,bhkv,bch->bchv", qc[:, i], state,
                                    _exp_clip(A[:, i])))
        state = (_exp_clip(A_tot[:, i])[..., None, None] * state + U[:, i])
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B, S, H, dv).to(v.dtype), state


class Plan(NamedTuple):
    """The launch plan of one call: the chunk padded to the kernel's
    template (``cp``), the scan pass's dv tile, each pass's shared memory
    a block and the scores workspace, in bytes."""
    cp: int
    tile_v: int
    scores_smem: int
    scan_smem: int
    workspace_bytes: int


def _padded_chunk(chunk: int) -> int:
    return next(cp for cp in (16, 32, 64, 128) if chunk <= cp)


def _scores_smem(cp: int) -> int:
    # two stages of a q and a k slab, A and g
    return 4 * (2 * 2 * cp * (_SLAB_SCORES + 4) + 2 * cp)


def _scan_smem(cp: int, dk: int, tile_v: int) -> int:
    # the state slice, the v tile, W, two stages of a q or k slab, eA, wk
    dk_pad = -(-dk // _SLAB_SCAN) * _SLAB_SCAN
    return 4 * (dk_pad * tile_v + cp * tile_v + cp * (cp + 4)
                + 2 * cp * (_SLAB_SCAN + 4) + 2 * cp)


def plan(B: int, S: int, H: int, dk: int, dv: int, chunk: int) -> Plan:
    """Size both passes of one call, as ``ssm_scan_plan_bytes`` in the .cu
    file does.  The dv tile is the widest of ``TILES_V`` whose scan block
    fits the card's shared memory.  Raises ValueError for a shape the
    kernel cannot take, before anything is allocated or launched."""
    if not 1 <= chunk <= 128 or S % chunk:
        raise ValueError(f"ssm_chunk_scan kernel needs 1 <= chunk <= 128 "
                         f"dividing S (S={S}, chunk={chunk}); pad through "
                         f"ops.ssm_chunk_scan")
    cp = _padded_chunk(chunk)
    fits = [tv for tv in TILES_V if _scan_smem(cp, dk, tv) <= _SMEM_MAX]
    if not fits:
        raise ValueError(f"ssm_chunk_scan kernel: chunk={chunk}, dk={dk} "
                         f"needs {_scan_smem(cp, dk, TILES_V[-1])} bytes of "
                         f"shared memory a block at the narrowest dv tile, "
                         f"more than the {_SMEM_MAX} a block has")
    tile_v = fits[0]
    if -(-dv // tile_v) > _GRID_Y_MAX:
        raise ValueError(f"ssm_chunk_scan kernel: dv={dv} needs more than "
                         f"{_GRID_Y_MAX} tiles of {tile_v}")
    ws = 4 * B * H * (S // chunk) * (cp * cp + 2 * cp)
    return Plan(cp, tile_v, _scores_smem(cp), _scan_smem(cp, dk, tile_v), ws)


def _lib():
    from .build import load
    lib = load("ssm_scan.cu")
    fn = lib.ssm_chunk_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_plan_bytes.argtypes = [ctypes.c_int] * 4
        lib.ssm_scan_plan_bytes.restype = ctypes.c_longlong
    return lib


def _launch(p: Plan, q, k, v, log_decay, gate, initial_state, y, state,
            chunk):
    """Allocate the workspace on the caller's device and launch both passes
    on the current stream, or the scores pass alone where ``v`` is None."""
    B, S, H, dk = q.shape
    dv = v.shape[-1] if v is not None else 0
    ws = torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                     device=q.device)
    # float32 rows the kernel may copy 16 bytes at a time: q and k (bit 0),
    # v and the state (bit 1)
    vec = (int(dk % 4 == 0 and q.data_ptr() % 16 == 0
               and k.data_ptr() % 16 == 0)
           | 2 * int(v is not None and dv % 4 == 0
                     and v.data_ptr() % 16 == 0))
    rc = _lib().ssm_chunk_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr() if v is not None else 0,
        log_decay.data_ptr(), gate.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else 0,
        y.data_ptr() if y is not None else 0,
        state.data_ptr() if state is not None else 0, ws.data_ptr(), B, S, H,
        dk, dv, chunk, p.tile_v, int(initial_state is not None),
        _DTYPES[q.dtype], vec, int(v is None),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_chunk_scan kernel launch failed: CUDA "
                           f"error {rc}")
    return ws


def scores_pass(q, k, log_decay, gate, *, chunk: int) -> torch.Tensor:
    """The scores pass alone, on CUDA tensors that ``ssm_chunk_scan``
    takes, for timing it on its own: returns the workspace, one record of
    W [cp][cp], exp(clip(A)) [cp] and the state-update weights [cp] per
    (b, h, chunk).  Not counted in ``ssm_chunk_scan.launches``."""
    B, S, H, dk = q.shape
    # the plan's workspace and scores-pass sizes do not depend on dv
    return _launch(plan(B, S, H, dk, 1, chunk), q, k, None, log_decay, gate,
                   None, None, None, chunk)


def ssm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, gate: torch.Tensor, *,
                   chunk: int, initial_state: Optional[torch.Tensor] = None):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), all float32 or all bfloat16;
    log_decay, gate: (B, S, H) float32; S a multiple of ``chunk`` (<= 128);
    initial_state: (B, H, dk, dv) float32 or None.  Returns (y (B, S, H,
    dv) in v's dtype, final state (B, H, dk, dv) float32)."""
    if is_dtensor(q) or is_dtensor(v):
        return on_shards(ssm_chunk_scan, q, k, v, log_decay, gate,
                         chunk=chunk, initial_state=initial_state)
    if q.device.type == "cpu":
        return ssm_chunk_scan_plain(q, k, v, log_decay, gate, chunk=chunk,
                                    initial_state=initial_state)
    if q.device.type != "cuda":
        raise ValueError(f"ssm_chunk_scan: unsupported device {q.device}")
    refuse_grad("ssm_chunk_scan", q, k, v, log_decay, gate, initial_state)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ssm_chunk_scan kernel takes matching float32/"
                        f"bfloat16 q, k, v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if log_decay.dtype != torch.float32 or gate.dtype != torch.float32:
        raise TypeError("ssm_chunk_scan kernel takes float32 log_decay and "
                        "gate")
    if k.shape != q.shape or v.shape[:3] != (B, S, H) \
            or log_decay.shape != (B, S, H) or gate.shape != (B, S, H):
        raise ValueError(f"ssm_chunk_scan: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_decay "
                         f"{tuple(log_decay.shape)}, gate "
                         f"{tuple(gate.shape)} do not agree")
    p = plan(B, S, H, dk, dv, chunk)
    tensors = [("q", q), ("k", k), ("v", v), ("log_decay", log_decay),
               ("gate", gate)]
    if initial_state is not None:
        if initial_state.dtype != torch.float32 \
                or initial_state.shape != (B, H, dk, dv):
            raise TypeError(f"ssm_chunk_scan: initial_state must be float32 "
                            f"of shape {(B, H, dk, dv)}")
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"ssm_chunk_scan: {name} must be contiguous on "
                             f"{q.device}")
    y = torch.empty_like(v)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if B * H * S * dv == 0:
        if initial_state is not None:
            state.copy_(initial_state)
        else:
            state.zero_()
        return y, state
    _launch(p, q, k, v, log_decay, gate, initial_state, y, state, chunk)
    ssm_chunk_scan.launches += 1
    return y, state


def on_shards(scan, q, k, v, log_decay, gate, *, chunk: int,
              initial_state=None):
    """``scan`` (this wrapper, or ``ops.ssm_chunk_scan``) on DTensors."""
    mesh = (q if is_dtensor(q) else v).device_mesh
    q, k, v, log_decay, gate, initial_state = (
        as_dtensor(t, mesh) for t in (q, k, v, log_decay, gate,
                                      initial_state))
    pl = kept(v, {0: 0})
    args = (q, k, v, log_decay, gate)
    if initial_state is None:
        return _on_shards(lambda *a: scan(*a, chunk=chunk), args,
                          (pl,) * 5, (pl, pl), mesh)
    return _on_shards(
        lambda *a: scan(*a[:5], chunk=chunk, initial_state=a[5]),
        args + (initial_state,), (pl,) * 6, (pl, pl), mesh)


ssm_chunk_scan.launches = 0
