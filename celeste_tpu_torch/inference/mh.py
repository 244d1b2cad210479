"""Random-walk Metropolis-Hastings, batch-major (counterpart of
``celeste_tpu/inference/mh.py``; BASELINE config 1 runs MH over position
and flux).

The state holds every chain at once: ``x`` [B, D], ``logp`` [B].  A step
draws from an explicit ``torch.Generator`` on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MHState(NamedTuple):
    x: torch.Tensor        # [B, D]
    logp: torch.Tensor     # [B]


class MHInfo(NamedTuple):
    accepted: torch.Tensor   # [B] bool
    logp: torch.Tensor       # [B] post-step log density


def mh_init(x0, logdensity_fn) -> MHState:
    """``logdensity_fn`` maps [B, D] -> [B]."""
    return MHState(x=x0, logp=logdensity_fn(x0))


def mh_kernel(logdensity_fn, step_scales, chains=None):
    """Build a step ``(generator, state) -> (state, info)``.  ``step_scales``
    is a [D] vector of per-axis proposal standard deviations.  ``chains``
    (a ``parallel.ensemble.ChainShard``): the state is this rank's rows of a
    sharded ensemble, and each step draws the ensemble's noise and keeps
    those rows, so the sharded chains are the unsharded ones."""

    def step(gen, state: MHState):
        x = state.x
        scales = torch.as_tensor(step_scales, dtype=x.dtype, device=x.device)
        noise = (torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                 if chains is None else chains.normal(gen, x))
        prop = x + scales * noise
        logp_prop = logdensity_fn(prop)
        u = (torch.rand(x.shape[0], generator=gen, dtype=x.dtype, device=x.device)
             if chains is None else chains.uniform(gen, state.logp))
        log_u = torch.log(u)
        accept = log_u < (logp_prop - state.logp)
        new = MHState(
            x=torch.where(accept[:, None], prop, x),
            logp=torch.where(accept, logp_prop, state.logp),
        )
        return new, MHInfo(accepted=accept, logp=new.logp)

    return step
