"""CUDA-graph capture of the port's hot entry points: the counterpart of
the reference's ``jax.jit``.

The reference compiles its decode step per sub-batch bucket, its batched
BF-IO solve per static shape and its device loop's step, and the host
launches each as one program.  Here each such region is a
``torch.cuda.CUDAGraph`` captured once per static shape and replayed on
every later call (:class:`Graphs`).  Capture is always on for a CUDA
tensor, as the reference's jit is; on a CPU tensor nothing is captured
and the same body runs op by op, as the kernels' plain versions do.
:func:`eager` is the one switch back to op-by-op launches on the card,
for comparing the two paths.  There is no fallback: a capture or replay
that fails raises.

A region's first call for a shape fills its static input buffers, runs
the body once on a side stream (a real call: its results are that call's
results, and every one-time set-up, such as a kernel's build or its
shared-memory attribute, happens outside the capture), then captures the
body on the same stream into the owner's memory pool.  Later calls copy
their inputs into the static buffers (host arrays through pinned staging,
``non_blocking``) and replay.  A graph bakes in the addresses of what its
body reads and writes outside its inputs (parameters, KV caches, pools):
each replay first checks that those tensors still have the storage the
graph captured, and captures again if one was rebound.

The kernel wrappers count their launches in Python, and a replay does not
call them.  So a capture records how many launches of each kernel its
graph holds (and takes them back off the counters, since nothing ran),
and every replay adds them: with capture on, the counters read what they
read op by op.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["Graphs", "eager", "captures", "launch_counters"]

_EAGER = contextvars.ContextVar("repro_torch_graphs_eager", default=False)


@contextlib.contextmanager
def eager():
    """Inside the block every captured region runs op by op on the card
    (the path before capture), for comparisons with the captured path."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def captures(device) -> bool:
    """True where a region called on ``device`` runs as a graph: a CUDA
    device, outside :func:`eager`, and not already inside a capture (a
    region called from another region's body, such as the solve inside
    the device loop's step, is recorded into the outer graph)."""
    return (torch.device(device).type == "cuda" and not _EAGER.get()
            and not torch.cuda.is_current_stream_capturing())


def launch_counters() -> dict:
    """The kernel wrappers (the five kernels and the backwards of K2 and
    K5) by name, each with its ``launches`` counter."""
    from ..kernels import bfio_swap as bs
    from ..kernels import decode_attention as da
    from ..kernels import paged_attention as pa
    from ..kernels import rms_norm as rk
    from ..kernels import ssm_scan as ss
    return {"rms_norm": rk.rms_norm,
            "rms_norm_bwd": rk.rms_norm_bwd,
            "paged_decode_attention": pa.paged_decode_attention,
            "bfio_swap": bs.swap_best,
            "decode_attention": da.decode_attention,
            "ssm_chunk_scan": ss.ssm_chunk_scan,
            "ssm_chunk_scan_bwd": ss.ssm_chunk_scan_bwd}


_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.bool_): torch.bool}


def _spec(a):
    if isinstance(a, np.ndarray):
        return tuple(a.shape), _NP_TO_TORCH[a.dtype], True
    return tuple(a.shape), a.dtype, False


class _Graph:
    """One captured region: its graph, static inputs and outputs, host
    staging, the storage it baked in and the launches it holds."""

    def __init__(self, graph, inputs, staging, outputs, ptrs, launches):
        self.graph = graph
        self.inputs = inputs
        self.staging = staging          # pinned (tensor, numpy view) | None
        self.outputs = outputs
        self.ptrs = ptrs
        self.launches = launches
        self.copied = None              # event after the last staging copy


class Graphs:
    """The captured regions of one owner (a cache backend, the solve on
    one device, a device loop), keyed by the caller's key and the shapes
    and dtypes of the inputs.  All of an owner's graphs share one memory
    pool: its replays never overlap.

    ``run(key, body, args, state, repeat)``: ``body(*inputs)`` returns a
    tensor or a tuple of tensors; ``args`` are numpy arrays (host inputs)
    or tensors on ``device``; ``state()`` lists the tensors outside the
    inputs whose storage the body reads or writes.  With ``repeat > 1``
    the body runs that many times from one copy of ``args``, so it must
    write its next inputs back into them (the device loop's step).  On a
    CPU device or under :func:`eager` the body runs op by op on the
    arguments (moved to ``device``).  The returned tensors are the
    graph's static outputs, which the next replay overwrites: a caller
    that hands them on clones them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: dict = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        #: how many graphs were captured and replayed (replays count
        #: each repetition)
        self.n_captured = 0
        self.n_replayed = 0

    def _on_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return a

    def run(self, key, body: Callable, args: Sequence,
            state: Callable[[], Sequence[torch.Tensor]] = tuple,
            repeat: int = 1):
        if not captures(self.device):
            inputs = [self._on_device(a) for a in args]
            out = None
            for _ in range(repeat):
                out = body(*inputs)
            return out
        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        specs = tuple(_spec(a) for a in args)
        full_key = (key, specs)
        ptrs = tuple(t.data_ptr() for t in state())
        g = self._graphs.get(full_key)
        stale = None
        if g is not None and g.ptrs != ptrs:
            # a tensor the graph baked in was rebound: never replay
            # against stale memory.  The stale graph lives until the new
            # one is captured: the pool is released with its last graph,
            # and its handle cannot be captured into after that
            stale, g = self._graphs.pop(full_key), None
        if g is None:
            out = self._capture(full_key, specs, body, args, ptrs)
            del stale
            repeat -= 1
            g = self._graphs[full_key]
            if repeat == 0:
                return out
        else:
            self._fill(g, args)
        counters = launch_counters()
        for _ in range(repeat):
            g.graph.replay()
            for name, n in g.launches.items():
                counters[name].launches += n
        self.n_replayed += repeat
        return g.outputs

    def _fill(self, g: _Graph, args) -> None:
        """Copy a call's inputs into the static buffers on the current
        stream (host arrays through their pinned staging)."""
        if g.copied is not None and not g.copied.query():
            g.copied.synchronize()      # the last copy still reads staging
        for dst, stage, a in zip(g.inputs, g.staging, args):
            if stage is None:
                dst.copy_(a)
            else:
                np.copyto(stage[1], a, casting="no")
                dst.copy_(stage[0], non_blocking=True)
        if g.copied is None:
            g.copied = torch.cuda.Event()
        g.copied.record()

    def _capture(self, full_key, specs, body, args, ptrs):
        """Static buffers, the real first call on a side stream, then the
        capture of the body on that stream; returns the first call's
        outputs."""
        dev = self.device
        inputs = [torch.empty(shape, dtype=dt, device=dev)
                  for shape, dt, _ in specs]
        staging = []
        for (shape, dt, host) in specs:
            if host:
                t = torch.empty(shape, dtype=dt, pin_memory=True)
                staging.append((t, t.numpy()))
            else:
                staging.append(None)
        g = _Graph(None, inputs, staging, None, ptrs, {})
        self._fill(g, args)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        s = self._stream
        here = torch.cuda.current_stream(dev)
        s.wait_stream(here)
        with torch.cuda.stream(s):
            out = body(*inputs)
        here.wait_stream(s)
        for t in (out if isinstance(out, tuple) else (out,)):
            t.record_stream(here)
        counters = launch_counters()
        before = {k: w.launches for k, w in counters.items()}
        graph = torch.cuda.CUDAGraph()
        # capture_begin/_end, not the torch.cuda.graph context: that one
        # synchronises the device and empties the allocator's cache before
        # every capture, a host wait and a round of cudaMalloc after it
        with torch.cuda.stream(s):
            graph.capture_begin(self._pool)
            try:
                g.outputs = body(*inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the error has invalidated the capture
                raise
            graph.capture_end()
        here.wait_stream(s)
        for k, w in counters.items():
            n = w.launches - before[k]
            if n:
                g.launches[k] = n
                w.launches = before[k]   # recorded, not launched
        g.graph = graph
        self._graphs[full_key] = g
        self.n_captured += 1
        return out
