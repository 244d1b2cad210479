"""Coordinate-wise slice sampling, batch-major (counterpart of
``celeste_tpu/inference/slice_.py``; Neal 2003 section 4, stepping-out and
shrinkage).

One step is one sweep over the D coordinates.  The JAX package runs a
``lax.while_loop`` per chain, coordinate and phase; here every chain of the
[B, D] batch steps in lockstep:

- each iteration of a phase evaluates the batched log-density once, with
  coordinate d moved only for the chains still active in that phase (a
  chain that is done keeps its bracket and value under a mask);
- a phase ends when no chain is active (one host sync per iteration) or at
  its cap, ``max_stepout`` for each side's stepping-out and ``max_shrink``
  for the shrinkage;
- a chain that reaches the shrinkage cap keeps its point, a null update as
  a rejected proposal is.

``n_evals`` counts the evaluations each chain used, as JAX counts them;
``n_calls`` counts the batched log-density calls of the sweep, the same
for every chain: the work the device did.

``chains``: the batch is this rank's rows of a larger one (the sharded
tempering ladder's ``LadderShard``): uniforms come from ``chains.uniform(gen,
like)`` and a phase ends when ``chains.any(active)`` is false, so every
rank draws and loops as one process holding every row would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SliceState(NamedTuple):
    x: torch.Tensor        # [B, D]
    logp: torch.Tensor     # [B]


class SliceInfo(NamedTuple):
    logp: torch.Tensor     # [B]
    n_evals: torch.Tensor  # [B] int32: evaluations this chain used this sweep
    n_calls: torch.Tensor  # [B] int32: batched log-density calls of the sweep


def slice_init(x0, logdensity_fn) -> SliceState:
    """``logdensity_fn`` maps [B, D] -> [B]."""
    return SliceState(x=x0, logp=logdensity_fn(x0))


def slice_kernel(logdensity_fn, widths, max_stepout: int = 16, max_shrink: int = 32,
                 chains=None):
    """Build a one-sweep step ``(generator, state) -> (state, info)``.
    ``widths`` is the [D] initial bracket width of each coordinate;
    ``chains`` as in the module docstring."""

    def step(gen, state: SliceState):
        x, logp = state.x.clone(), state.logp
        b, dim = x.shape
        kw = dict(dtype=x.dtype, device=x.device)
        w = torch.as_tensor(widths, **kw)
        n_evals = torch.zeros(b, dtype=torch.int32, device=x.device)
        n_calls = 0

        def uniform():
            return (torch.rand(b, generator=gen, **kw) if chains is None
                    else chains.uniform(gen, logp))

        def any_(active):
            return bool(active.any()) if chains is None else chains.any(active)

        def logp_at(d, v, active):
            """The batched log-density with coordinate d set to v on the
            active chains."""
            nonlocal n_calls
            n_calls += 1
            moved = x.clone()
            moved[:, d] = torch.where(active, v, x[:, d])
            return logdensity_fn(moved)

        def step_out(d, v, log_y, step):
            """Move the bracket end v by ``step`` until it leaves the slice."""
            active = torch.ones(b, dtype=torch.bool, device=x.device)
            n = torch.zeros(b, dtype=torch.int32, device=x.device)
            for _ in range(max_stepout):
                if not any_(active):
                    break
                inside = logp_at(d, v, active) > log_y
                n += active.to(torch.int32)
                v = torch.where(active & inside, v + step, v)
                active &= inside
            return v, n

        for d in range(dim):
            log_y = logp + torch.log(uniform())
            lo0 = x[:, d] - w[d] * uniform()
            lo, n_lo = step_out(d, lo0, log_y, -w[d])
            hi, n_hi = step_out(d, lo0 + w[d], log_y, w[d])

            # shrinkage
            x_d = x[:, d].clone()
            accepted = torch.zeros(b, dtype=torch.bool, device=x.device)
            x_new, logp_new = x_d, logp
            n_shrink = torch.zeros(b, dtype=torch.int32, device=x.device)
            for _ in range(max_shrink):
                active = ~accepted
                if not any_(active):
                    break
                prop = lo + uniform() * (hi - lo)
                lp_prop = logp_at(d, prop, active)
                ok = active & (lp_prop > log_y)
                miss = active & ~ok
                lo = torch.where(miss & (prop < x_d), prop, lo)
                hi = torch.where(miss & (prop >= x_d), prop, hi)
                x_new = torch.where(ok, prop, x_new)
                logp_new = torch.where(ok, lp_prop, logp_new)
                n_shrink += active.to(torch.int32)
                accepted |= ok
            x[:, d] = torch.where(accepted, x_new, x_d)
            logp = torch.where(accepted, logp_new, logp)
            n_evals += n_lo + n_hi + n_shrink + 1
        info = SliceInfo(logp=logp, n_evals=n_evals, n_calls=torch.full_like(n_evals, n_calls))
        return SliceState(x=x, logp=logp), info

    return step
