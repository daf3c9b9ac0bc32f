"""The kernel wrappers on DTensors (a model under a mesh).

A wrapper given a DTensor runs through ``local_map`` on its local shard,
with the placements its kernel needs: a mesh dim keeps an input's
``Shard(dim)`` only where the kernel can take that dim cut (the batch
rows, the KV heads); every other placement, a shard of a dim the kernel
needs whole or a pending sum, is redistributed to ``Replicate()`` in the
open, so a dry run counts that collective.  On a CUDA shard the wrapper
then launches its kernel, on a CPU shard it runs the plain version, as
for any tensor.
"""
from __future__ import annotations

from typing import Callable, Sequence

from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["is_dtensor", "kept", "as_dtensor", "on_shards", "replicated",
           "on_batch_shards"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def kept(t: DTensor, dims: dict) -> tuple:
    """``t``'s placements with ``Shard(d)`` kept (as ``Shard(dims[d])``)
    for the dims in ``dims`` and everything else replicated."""
    out = []
    for p in t.placements:
        d = None
        if isinstance(p, Shard):
            d = p.dim % t.dim()
        out.append(Shard(dims[d]) if d in dims else Replicate())
    return tuple(out)


def as_dtensor(t, mesh):
    """A DTensor for ``t``: itself, or a plain tensor that every rank holds
    whole, replicated."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_shards(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements, mesh):
    """``fn`` on the local shards of ``args`` (DTensors), each
    redistributed first to its placements; the outputs are DTensors with
    ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import Placement
    # local_map reads a tuple as one entry per output, a list as the
    # placements of a single output
    if all(isinstance(p, Placement) for p in out_placements):
        out = list(out_placements)
    else:
        out = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=out,
                     in_placements=tuple(tuple(p) for p in in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def on_batch_shards(fn: Callable, rows: Sequence, whole: Sequence = (),
                    n_out: int = 1, **kw):
    """``fn(*rows, *whole, **kw)`` (a function of each batch row alone,
    with ``n_out`` tensor outputs, each with a batch dim) on each rank's
    batch rows: ``rows`` (batch first) cut as the first DTensor among them
    cuts its batch, ``whole`` (weights) and every other dim whole."""
    first = next(a for a in rows if is_dtensor(a))
    mesh = first.device_mesh
    pl = kept(first, {0: 0})
    args = tuple(as_dtensor(a, mesh) for a in tuple(rows) + tuple(whole))
    return on_shards(lambda *a: fn(*a, **kw), args,
                     (pl,) * len(rows) + (replicated(mesh),) * len(whole),
                     pl if n_out == 1 else (pl,) * n_out, mesh)
