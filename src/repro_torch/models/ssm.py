"""State-space / recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

Mamba2 and mLSTM share one *chunked gated linear attention* core:

    S_t = exp(a_t) * S_{t-1} + i_t * k_t v_t^T          (state: dk x dv)
    y_t = q_t . S_t

computed chunk-parallel: an intra-chunk quadratic form and an inter-chunk
state carry.  The scan itself is kernel K5
(:mod:`repro_torch.kernels.ssm_scan`): the Hopper kernel on a CUDA tensor,
its plain version on a CPU tensor.  The H=1 broadcast of q/k (Mamba2), the
mLSTM normalizer column and the padding of S to the chunk stay outside the
kernel, as in the reference.

sLSTM has a *nonlinear* recurrence (its gates read h_{t-1}), so it is a
Python loop over time (the reference's ``lax.scan``; it has no kernel).

Decode = single-step state updates (the delta_k == 0 workload class of the
paper's Theorem 3: per-request serving cost is constant in response length).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.sharded import is_dtensor, on_batch_shards

__all__ = [
    "chunked_linear_attention",
    "linear_attention_step",
    "causal_conv1d",
    "causal_conv1d_step",
    "slstm_scan",
    "slstm_step",
]

_CLIP = 60.0


def chunked_linear_attention(q, k, v, log_decay, gate_in, *,
                             chunk: int = 128,
                             initial_state: Optional[torch.Tensor] = None,
                             normalize: bool = False):
    """Chunk-parallel scan of the gated linear-attention recurrence.

    q, k: (B, S, H, dk); v: (B, S, H, dv); log_decay: (B, S, H) (<= 0);
    gate_in: (B, S, H) input gates i_t.  k/q may have H=1 (shared across
    heads, Mamba2-style) — broadcast.

    Returns (y (B, S, H, dv) in v's dtype, final_state (B, H, dk, dv(+1))
    float32).  If ``normalize``, y is divided by a normalizer running sum
    (mLSTM style: an extra all-ones value column, kept in the state)."""
    B, S, H, dv = v.shape
    dk = k.shape[-1]
    out_dtype = v.dtype
    vf = v.float()
    if normalize:
        vf = torch.cat([vf, vf.new_ones(vf.shape[:-1] + (1,))], dim=-1)
    qf, kf = q.float(), k.float()
    if kf.shape[2] == 1 and H != 1:
        kf = kf.expand(B, S, H, dk)
    if qf.shape[2] == 1 and H != 1:
        qf = qf.expand(B, S, H, dk)
    if initial_state is not None:
        initial_state = initial_state.float()
        if normalize and initial_state.shape[-1] == dv:
            initial_state = torch.cat(
                [initial_state,
                 initial_state.new_zeros(initial_state.shape[:-1] + (1,))],
                dim=-1)
        initial_state = initial_state.contiguous()
    y, state = ops.ssm_chunk_scan(
        qf.contiguous(), kf.contiguous(), vf.contiguous(),
        log_decay.float().contiguous(), gate_in.float().contiguous(),
        chunk=min(chunk, S), initial_state=initial_state)
    if normalize:
        norm = y[..., -1:]
        y = y[..., :-1] / torch.clamp(norm.abs(), min=1e-6)
    return y.to(out_dtype), state


def linear_attention_step(q, k, v, log_decay, gate_in, state, *,
                          normalize: bool = False):
    """Single decode step of the same recurrence.

    q, k: (B, H, dk); v: (B, H, dv); log_decay, gate_in: (B, H);
    state: (B, H, dk, dv(+1)).  Returns (y (B, H, dv), new_state).  On
    DTensors it runs on each rank's batch rows."""
    if is_dtensor(v) or is_dtensor(state):
        return on_batch_shards(linear_attention_step,
                               (q, k, v, log_decay, gate_in, state),
                               n_out=2, normalize=normalize)
    qf, kf, vf = q.float(), k.float(), v.float()
    if normalize:
        vf = torch.cat([vf, vf.new_ones(vf.shape[:-1] + (1,))], dim=-1)
    a = torch.exp(torch.clamp(log_decay.float(), -_CLIP, _CLIP))
    u = torch.einsum("bhk,bhv,bh->bhkv", kf, vf, gate_in.float())
    state = a[..., None, None] * state.float() + u
    y = torch.einsum("bhk,bhkv->bhv", qf, state)
    if normalize:
        norm = y[..., -1:]
        y = y[..., :-1] / torch.clamp(norm.abs(), min=1e-6)
    return y.to(v.dtype), state


def causal_conv1d(x, w, *, initial_state=None, lengths=None):
    """Depthwise causal conv over time.  x: (B, S, D); w: (K, D).

    Returns (y (B, S, D), final_state (B, K-1, D)).  With ``lengths`` the
    final state is gathered at the last *valid* K-1 positions per row
    (ragged prefill)."""
    B, S, D = x.shape
    K = w.shape[0]
    if initial_state is None:
        initial_state = x.new_zeros((B, K - 1, D))
    xp = torch.cat([initial_state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    for i in range(K):       # K is small (4): unrolled taps
        y = y + xp[:, i:i + S].float() * w[i].float()[None, None, :]
    if lengths is None:
        state = xp[:, S:]    # last K-1 inputs
    else:
        # xp index of the j-th state entry for row b: lengths[b] + j
        idx = lengths.long()[:, None] + torch.arange(K - 1,
                                                     device=x.device)[None]
        state = torch.gather(xp, 1, idx[:, :, None].expand(B, K - 1, D))
    return y.to(x.dtype), state


def causal_conv1d_step(x, w, state):
    """Single-token conv step.  x: (B, D); state: (B, K-1, D)."""
    xp = torch.cat([state, x[:, None, :]], dim=1)        # (B, K, D)
    y = torch.einsum("bkd,kd->bd", xp.float(), w.float())
    return y.to(x.dtype), xp[:, 1:]


# --------------------------------------------------------------------------
# sLSTM (nonlinear recurrence -> sequential loop)
# --------------------------------------------------------------------------

def _slstm_cell(h, c, n, m, x_gates, r_weights):
    """One sLSTM step.  h, c, n: (B, H, hd); m: (B, H, hd) stabilizer.
    x_gates: (B, H, 4, hd) input contributions (W x + b) for i,f,z,o;
    r_weights: (H, 4, hd, hd) block-diagonal recurrent weights."""
    dt = torch.promote_types(h.dtype, r_weights.dtype)
    rec = torch.einsum("bhd,hgde->bhge", h.to(dt), r_weights.to(dt))
    g = (x_gates + rec).float()
    i_pre, f_pre, z_pre, o_pre = g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3]
    # exponential gating with stabilizer (xLSTM eqs.)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(torch.clamp(i_pre - m_new, -_CLIP, 0))
    f_g = torch.exp(torch.clamp(log_f + m - m_new, -_CLIP, 0))
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_scan(x_gates, r_weights, *, initial=None, valid=None):
    """Sequential sLSTM over time.  x_gates: (B, S, H, 4, hd).
    ``valid``: optional (B, S) bool — padding steps leave the state frozen.
    Returns (h_seq (B, S, H, hd), final (h, c, n, m)).  On DTensors the
    loop runs on each rank's batch rows."""
    if is_dtensor(x_gates):
        ni = 0 if initial is None else 4

        def local(xg, *a):
            return slstm_scan(xg, a[-1], initial=tuple(a[:ni]) or None,
                              valid=a[ni] if valid is not None else None)
        rows = (x_gates,) + tuple(initial or ()) \
            + ((valid,) if valid is not None else ())
        return on_batch_shards(local, rows, (r_weights,), n_out=5)
    B, S, H, _, hd = x_gates.shape
    if initial is None:
        z = torch.zeros((B, H, hd), dtype=torch.float32,
                        device=x_gates.device)
        initial = (z, z, z, torch.full((B, H, hd), -1e30,
                                       dtype=torch.float32,
                                       device=x_gates.device))
    h, c, n, m = initial
    hs = []
    for t in range(S):
        h2, c2, n2, m2 = _slstm_cell(h, c, n, m, x_gates[:, t], r_weights)
        if valid is not None:
            keep = valid[:, t][:, None, None]
            h2 = torch.where(keep, h2, h)
            c2 = torch.where(keep, c2, c)
            n2 = torch.where(keep, n2, n)
            m2 = torch.where(keep, m2, m)
        h, c, n, m = h2, c2, n2, m2
        hs.append(h)
    return torch.stack(hs, dim=1).to(x_gates.dtype), (h, c, n, m)


def slstm_step(x_gates, r_weights, state):
    """Single decode step.  x_gates: (B, H, 4, hd).  On DTensors it runs
    on each rank's batch rows."""
    if is_dtensor(x_gates):
        return on_batch_shards(lambda xg, *a: slstm_step(xg, a[-1], a[:4]),
                               (x_gates,) + tuple(state), (r_weights,),
                               n_out=5)
    h, c, n, m = state
    h, c, n, m = _slstm_cell(h, c, n, m, x_gates, r_weights)
    return h.to(x_gates.dtype), (h, c, n, m)
