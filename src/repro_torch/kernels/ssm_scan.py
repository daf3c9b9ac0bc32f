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
Its design: each dv column of the state evolves on its own, so the grid is
(B * H, ceil(dv / 32)) and each block keeps its (dk x 32) fp32 state slice
in shared memory across a loop over the chunks, which takes the place of
the TPU's sequential grid axis.  Per chunk it streams q and k through
shared memory in 32-wide dk slabs, accumulating the C x C scores in
registers (an R x R micro-tile per thread) and q . S_prev beside them,
then forms the masked decay-weighted matrix, y, and the state update.  The
scores are recomputed for every dv tile.  A state slice of xlstm's mLSTM
(512 x 513 fp32 per head) would not fit one block's shared memory: the dv
split is what makes it fit.

:func:`ssm_chunk_scan` is the wrapper: on a CPU tensor it runs
:func:`ssm_chunk_scan_plain`; on a CUDA tensor it launches the kernel or
raises.  ``ssm_chunk_scan.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["ssm_chunk_scan", "ssm_chunk_scan_plain", "smem_bytes"]

CLIP = 60.0
TILE_V = 32          # dv columns per block
_SLAB = 32           # dk rows per shared-memory slab
_SMEM_MAX = 232448   # the H100's shared memory per block, in bytes
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


def smem_bytes(chunk: int, dk: int) -> int:
    """Shared memory one block of the kernel needs (see the .cu file)."""
    return 4 * (chunk * chunk + 2 * chunk * (_SLAB + 1) + dk * TILE_V
                + chunk * TILE_V + 3 * chunk)


def _lib():
    from .build import load
    lib = load("ssm_scan.cu")
    fn = lib.ssm_chunk_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ssm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, gate: torch.Tensor, *,
                   chunk: int, initial_state: Optional[torch.Tensor] = None):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), all float32 or all bfloat16;
    log_decay, gate: (B, S, H) float32; S a multiple of ``chunk`` (<= 128);
    initial_state: (B, H, dk, dv) float32 or None.  Returns (y (B, S, H,
    dv) in v's dtype, final state (B, H, dk, dv) float32)."""
    if q.device.type == "cpu":
        return ssm_chunk_scan_plain(q, k, v, log_decay, gate, chunk=chunk,
                                    initial_state=initial_state)
    if q.device.type != "cuda":
        raise ValueError(f"ssm_chunk_scan: unsupported device {q.device}")
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
    if not 1 <= chunk <= 128 or S % chunk:
        raise ValueError(f"ssm_chunk_scan kernel needs 1 <= chunk <= 128 "
                         f"dividing S (S={S}, chunk={chunk}); pad through "
                         f"ops.ssm_chunk_scan")
    if smem_bytes(chunk, dk) > _SMEM_MAX:
        raise ValueError(f"ssm_chunk_scan kernel: chunk={chunk}, dk={dk} "
                         f"needs {smem_bytes(chunk, dk)} bytes of shared "
                         f"memory, more than a block has")
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
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                log_decay.data_ptr(), gate.data_ptr(),
                initial_state.data_ptr() if initial_state is not None else 0,
                y.data_ptr(), state.data_ptr(), B, S, H, dk, dv, chunk,
                int(initial_state is not None), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_chunk_scan kernel launch failed: CUDA "
                           f"error {rc}")
    ssm_chunk_scan.launches += 1
    return y, state


ssm_chunk_scan.launches = 0
