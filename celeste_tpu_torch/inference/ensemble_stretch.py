"""Affine-invariant ensemble sampler: the Goodman & Weare (2010) stretch
move, the emcee algorithm (counterpart of
``celeste_tpu/inference/ensemble_stretch.py``).

The complementary-ensemble formulation: the K walkers of a [K, D] ensemble
split into two halves, and each half moves at once against the other (one
batched log-density call of K/2 rows per half), so a sweep is two calls
with no loop over walkers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StretchState(NamedTuple):
    xs: torch.Tensor      # [K, D] walker positions (K even)
    logps: torch.Tensor   # [K]


class StretchInfo(NamedTuple):
    accept_rate: torch.Tensor
    logp_mean: torch.Tensor


def stretch_init(xs, logdensity_fn) -> StretchState:
    return StretchState(xs=xs, logps=logdensity_fn(xs))


def stretch_kernel(logdensity_fn, a: float = 2.0):
    """Build a one-sweep kernel ``(generator, state) -> (state, info)``
    (both half-ensembles updated).  ``a`` is the stretch scale (emcee's
    default 2)."""

    def half_update(gen, movers, movers_lp, others):
        n, d = movers.shape
        kw = dict(generator=gen, dtype=movers.dtype, device=movers.device)
        # z ~ g(z) prop 1/sqrt(z) on [1/a, a]
        z = ((a - 1.0) * torch.rand(n, **kw) + 1.0) ** 2 / a
        picks = torch.randint(0, others.shape[0], (n,), generator=gen, device=movers.device)
        partners = others[picks]
        prop = partners + z[:, None] * (movers - partners)
        prop_lp = logdensity_fn(prop)
        log_ratio = (d - 1.0) * torch.log(z) + prop_lp - movers_lp
        accept = torch.log(torch.rand(n, **kw)) < log_ratio
        return (torch.where(accept[:, None], prop, movers),
                torch.where(accept, prop_lp, movers_lp), accept)

    def step(gen, state: StretchState):
        half = state.xs.shape[0] // 2
        a_xs, b_xs = state.xs[:half], state.xs[half:]
        a_lp, b_lp = state.logps[:half], state.logps[half:]
        a_xs, a_lp, acc_a = half_update(gen, a_xs, a_lp, b_xs)
        b_xs, b_lp, acc_b = half_update(gen, b_xs, b_lp, a_xs)
        xs, logps = torch.cat([a_xs, b_xs]), torch.cat([a_lp, b_lp])
        info = StretchInfo(
            accept_rate=torch.mean(torch.cat([acc_a, acc_b]).to(torch.float32)),
            logp_mean=torch.mean(logps))
        return StretchState(xs=xs, logps=logps), info

    return step
