"""The collectives of the sharded paths, over a named mesh dimension
(counterpart of ``celeste_tpu/parallel/collectives.py``).

- ``all_reduce_sum`` / ``all_mean``: the pooled chain-ensemble statistics,
  and the crowded field's lambda, summed over the ``sources`` dimension
  before the Poisson log;
- ``ring_shift`` / ``neighbor_exchange``: the permutations of the
  tempering-ladder swaps;
- ``gather_axis``: every rank's tensor, stacked, for diagnostics.

Every one is built from ``all_reduce``, the one collective that every
backend takes on every device (gloo on CUDA tensors takes only
``all_reduce`` and ``broadcast``, and gloo is how several ranks share one
card).  A permutation or gather reduces a buffer [n, ...] in which each
rank has filled its own row: exact for finite values, n times the bytes of
a point-to-point exchange, and off the sampler's hot path.

Gradients across the ``sources`` dimension, whose ranks hold the same chain
states and each render their own sources:

- :func:`sum_over`: forward all-reduce, backward identity (every rank
  already holds the same cotangent of the sum);
- :func:`replicated_in`: forward identity, backward all-reduce (each rank's
  cotangent covers only the rows it read).

Every function here is the identity, and calls no collective, where the
dimension holds one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from celeste_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def _all_reduce(x, group):
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum(x, mesh, axis: str):
    """Sum over the ranks of ``axis``."""
    group = axis_group(mesh, axis)
    return x if group is None else _all_reduce(x, group)


def all_mean(x, mesh, axis: str):
    """Mean over the ranks of ``axis``."""
    return all_reduce_sum(x, mesh, axis) / axis_size(mesh, axis)


def gather_axis(x, mesh, axis: str, tiled: bool = False):
    """Every rank's ``x`` along ``axis``, stacked [n, ...] in rank order (or
    concatenated along the first dimension with ``tiled=True``)."""
    n = axis_size(mesh, axis)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[axis_index(mesh, axis)] = x
    out = all_reduce_sum(buf, mesh, axis)
    return out.reshape((-1,) + tuple(x.shape[1:])) if tiled else out


def ring_shift(x, mesh, axis: str, shift: int = 1):
    """Ring rotation: rank i receives the value held by rank (i - shift) mod n."""
    n = axis_size(mesh, axis)
    return gather_axis(x, mesh, axis)[(axis_index(mesh, axis) - shift) % n]


def neighbor_exchange(x, mesh, axis: str):
    """Swap with the paired neighbour (0<->1, 2<->3, ...); the last rank of
    an odd dimension keeps its own value."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    partner = i ^ 1 if (i ^ 1) < n else i
    return gather_axis(x, mesh, axis)[partner]


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


def sum_over(x, mesh, axis: str):
    """The sum of every rank's ``x`` along ``axis``, whose gradient is the
    identity: the ranks use the sum identically, so each already holds the
    whole cotangent (``torch.distributed.nn``'s all-reduce would sum it
    again, scaling every gradient by the number of ranks)."""
    group = axis_group(mesh, axis)
    return x if group is None else _SumOver.apply(x, group)


def replicated_in(x, mesh, axis: str):
    """``x``, held alike by every rank along ``axis``, entering code in
    which each rank reads its own part: the backward sums the ranks'
    cotangents, so every rank ends with the cotangent of all of ``x``."""
    group = axis_group(mesh, axis)
    return x if group is None else _ReplicatedIn.apply(x, group)
