"""Parallel tempering with the ladder sharded over ranks (counterpart of
``celeste_tpu/parallel/pt_sharded.py``).

``inference.tempering.pt_kernel`` keeps the whole ladder in one batch.
Here the T replicas are split over the ``temps`` dimension of a mesh
(``parallel.mesh``): each rank holds T / n of them, contiguous, and moves
them locally; the swap sweep then needs every replica's log density and,
for the pairs that straddle a rank boundary, the neighbours' edge states.

- The [..., T] log densities: a zero-padded [..., T] buffer in which each
  rank fills its replicas, all-reduced (the port's collectives are
  all-reduce only; ROADMAP.md's multi-device design).  Every rank then
  makes every swap decision, redundantly, from the same uniforms.
- The edges: ``collectives.ring_shift`` of the first and the last local
  replica, so row g's source perm[g] (g-1, g or g+1) is local or an edge.

Random numbers: every rank draws each step's numbers at the whole ladder's
shape from one generator seeded alike and keeps its replicas'
(:class:`LadderShard`, the inner kernels' ``noise``), and draws the swap
uniforms whole, so the sharded ladder is the in-device one, step for step.
"""

from __future__ import annotations

import torch

from celeste_tpu_torch.inference.tempering import PTInfo, PTState, move, swap_decisions
from celeste_tpu_torch.parallel.collectives import all_reduce_sum, ring_shift
from celeste_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def _local(mesh, axis_name, n_temps):
    """(first, last + 1) of this rank's replicas of an ``n_temps`` ladder."""
    n = axis_size(mesh, axis_name)
    if n_temps % n:
        raise ValueError(f"{n_temps} temperatures do not divide over {n} ranks")
    t_loc = n_temps // n
    lo = axis_index(mesh, axis_name) * t_loc
    return lo, lo + t_loc


class LadderShard:
    """This rank's replicas of a ladder of ``n_temps``, for the inner
    kernels' ``noise``: ``normal(gen, like)`` and ``uniform(gen, like)``
    draw at the whole ladder's shape and return this rank's rows (``like``
    [R_loc, ...], the flattened [..., T_loc] rows); ``any(mask)`` is true
    where any rank's mask has a true entry (the lockstep slice's loops)."""

    def __init__(self, mesh, axis_name: str, n_temps: int):
        self.mesh, self.axis_name, self.n_temps = mesh, axis_name, int(n_temps)
        self.lo, self.hi = _local(mesh, axis_name, self.n_temps)

    def _draw(self, fn, gen, like):
        t_loc = self.hi - self.lo
        full = fn((like.shape[0] // t_loc, self.n_temps) + tuple(like.shape[1:]), generator=gen,
                  dtype=like.dtype, device=like.device)
        return full[:, self.lo:self.hi].reshape(like.shape)

    def normal(self, gen, like):
        return self._draw(torch.randn, gen, like)

    def uniform(self, gen, like):
        return self._draw(torch.rand, gen, like)

    def any(self, mask) -> bool:
        flag = mask.any().to(torch.float32)
        return bool(all_reduce_sum(flag, self.mesh, self.axis_name) > 0)


def from_first_rank(x, mesh, axis_name: str = "temps"):
    """The first rank's ``x`` on every rank of ``axis_name`` (an all-reduce of
    ``x`` there and zeros elsewhere)."""
    if axis_group(mesh, axis_name) is None:
        return x
    mine = x if axis_index(mesh, axis_name) == 0 else torch.zeros_like(x)
    return all_reduce_sum(mine, mesh, axis_name)


def sharded_pt_init(xs, logdensity_fn, mesh, axis_name: str = "temps") -> PTState:
    """This rank's part of ``pt_init(xs, logdensity_fn)``: ``xs`` is the
    whole ladder [..., T, D], alike on every rank; the state holds this
    rank's replicas [..., T_loc, D] and their log densities."""
    lo, hi = _local(mesh, axis_name, xs.shape[-2])
    local = xs[..., lo:hi, :]
    return PTState(xs=local, logps=logdensity_fn(local), even_phase=True)


def sharded_pt_kernel(logdensity_fn, inner_kernel_fn, betas, mesh, axis_name: str = "temps"):
    """Tempered step with the ladder sharded over ``mesh[axis_name]``.

    The contract of ``pt_kernel``: ``inner_kernel_fn(beta, idx)`` returns a
    bundle targeting ``beta * logdensity`` (its ``noise`` a
    :class:`LadderShard` of this ladder, so each rank draws what the
    in-device ladder draws for its replicas); ``betas`` [T] with betas[0]
    == 1.  Returns ``(gen, PTState) -> (PTState, PTInfo)`` on this rank's
    replicas; the info's swap records and cold logp cover the whole ladder
    and are alike on every rank.
    """

    def step(gen, state: PTState):
        xs_l, logps_l = state.xs, state.logps
        b = torch.as_tensor(betas, dtype=xs_l.dtype, device=xs_l.device)
        t = b.shape[0]
        lo, hi = _local(mesh, axis_name, t)
        t_loc = hi - lo
        lead = logps_l.shape[:-1]
        beta = b[lo:hi].expand(logps_l.shape)
        idx = torch.arange(lo, hi, device=xs_l.device).expand(logps_l.shape)
        # (a) local moves at each replica's own beta
        xs_l, logps_l = move(inner_kernel_fn(beta, idx), gen, xs_l, logps_l, beta)

        # (b) the swap sweep, decided redundantly on every rank from the
        # whole ladder's log densities and one draw of uniforms
        buf = logps_l.new_zeros(lead + (t,))
        buf[..., lo:hi] = logps_l
        all_logps = all_reduce_sum(buf, mesh, axis_name)
        u = torch.rand(lead + (t - 1,), generator=gen, dtype=xs_l.dtype, device=xs_l.device)
        accept, active, perm = swap_decisions(all_logps, b, state.even_phase, u)

        # apply: row g's source perm[g] is g-1, g or g+1, so at most the edge
        # replica of each neighbouring rank is needed
        left_edge = ring_shift(xs_l[..., -1, :], mesh, axis_name, shift=1)    # from rank r-1
        right_edge = ring_shift(xs_l[..., 0, :], mesh, axis_name, shift=-1)   # from rank r+1
        j = torch.arange(t_loc, device=xs_l.device)
        pg = perm[..., lo:hi]                                                 # [..., t_loc]
        rows = torch.gather(xs_l, -2, torch.clamp(pg - lo, 0, t_loc - 1)[..., None]
                            .expand(xs_l.shape))
        from_left = ((pg == lo + j - 1) & (j == 0))[..., None]
        from_right = ((pg == lo + j + 1) & (j == t_loc - 1))[..., None]
        rows = torch.where(from_left, left_edge[..., None, :], rows)
        rows = torch.where(from_right, right_edge[..., None, :], rows)
        new_logps = torch.gather(all_logps, -1, pg)
        logp_cold = torch.gather(all_logps, -1, perm[..., :1])[..., 0]
        return (PTState(xs=rows, logps=new_logps, even_phase=not state.even_phase),
                PTInfo(swap_accept=accept, swap_active=active, logp_cold=logp_cold))

    return step
