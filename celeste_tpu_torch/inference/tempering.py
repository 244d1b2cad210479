"""Parallel tempering, batch-major (counterpart of
``celeste_tpu/inference/tempering.py``; slice-within-parallel-tempering is
the reference's sampler for the multimodal quasar redshift posterior, Miller
et al. NIPS 2015).

The ladder is an axis of the chain batch.  A state holds ``xs`` [..., T, D]
and the untempered ``logps`` [..., T] (index 0 of T is the cold replica;
the leading axes are independent systems, and targets); the log density
maps [..., T, D] -> [..., T].  A step is

(a) one move of every replica at its own inverse temperature: the rows are
    flattened to [R, D] and the inner kernel targets ``beta_row *
    logdensity``, seeded with the carried untempered logp (no re-evaluation
    on entry);
(b) the even/odd adjacent swap sweep (even pairs on one step, odd on the
    next): pair (i, i+1) swaps with probability min(1, exp((beta_i -
    beta_{i+1}) (logp_{i+1} - logp_i))), applied as a gather along T.

The inner kernel families (``mh_at_beta``, ``slice_at_beta``, ``hmc_at_beta``,
``hmc_at_beta_adaptive``) are factories ``(beta, idx) -> bundle``: ``beta``
and ``idx`` are the rows' inverse temperatures and replica indices, shaped
[..., T] like the ladder, and the bundle's ``init(x, logp)`` / ``step(gen,
state)`` act on the flattened rows.  ``noise`` (an object with ``normal(gen,
like)`` and ``uniform(gen, like)``, as ``parallel.ensemble.ChainShard``)
supplies the random numbers instead of ``gen`` where a caller needs them
drawn another way: per photo-z target, or at the whole ladder's shape on
one rank of a sharded ladder (``parallel.pt_sharded``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from celeste_tpu_torch.inference.hmc import HMCState, hmc_kernel, hmc_warmup, value_and_grad
from celeste_tpu_torch.inference.mh import MHState, mh_kernel
from celeste_tpu_torch.inference.slice_ import SliceState, slice_kernel


class PTState(NamedTuple):
    xs: torch.Tensor       # [..., T, D] replica positions (index 0 = cold)
    logps: torch.Tensor    # [..., T] untempered log density at each replica
    even_phase: bool       # which swap parity this step attempts


class PTInfo(NamedTuple):
    swap_accept: torch.Tensor   # [..., T-1] bool, adjacent-pair acceptances
    swap_active: torch.Tensor   # [T-1] bool, which pairs were attempted
    logp_cold: torch.Tensor     # [...]


class KernelBundle(NamedTuple):
    init: Callable
    step: Callable


def pt_init(xs, logdensity_fn) -> PTState:
    return PTState(xs=xs, logps=logdensity_fn(xs), even_phase=True)


def swap_decisions(logps, betas, even_phase: bool, u):
    """The even/odd sweep's decisions: ``logps`` [..., T], ``betas`` [T],
    ``u`` [..., T-1] uniforms.  Returns (accept [..., T-1], active [T-1],
    perm [..., T]), where replica g takes the state of replica perm[g]."""
    t = betas.shape[0]
    i = torch.arange(t - 1, device=logps.device)
    active = (i % 2 == 0) == bool(even_phase)
    log_ratio = (betas[:-1] - betas[1:]) * (logps[..., 1:] - logps[..., :-1])
    accept = active & (torch.log(u) < log_ratio)
    # pairs within a parity class are disjoint, so the two writes never collide
    perm = torch.arange(t, device=logps.device).expand(logps.shape).clone()
    perm[..., :-1] = torch.where(accept, i + 1, i)
    perm[..., 1:] = torch.where(accept, i, perm[..., 1:])
    return accept, active, perm


def swap_sweep(xs, logps, betas, even_phase: bool, u):
    """Apply the even/odd swap sweep to ``xs`` [..., T, D] and ``logps``
    [..., T]: a pure function of its inputs.  Returns (xs, logps, accept,
    active)."""
    accept, active, perm = swap_decisions(logps, betas, even_phase, u)
    xs = torch.gather(xs, -2, perm[..., None].expand(xs.shape))
    return xs, torch.gather(logps, -1, perm), accept, active


def _rows(logdensity_fn, shape):
    """``logdensity_fn`` of [..., T, D] as a function of the flattened rows
    [R, D] -> [R], for a ladder of ``shape`` [..., T]."""
    return lambda x: logdensity_fn(x.reshape(*shape, x.shape[-1])).reshape(-1)


def _tempered(logdensity_fn, beta):
    """``beta * logdensity`` on the flattened rows of a ladder shaped like ``beta``."""
    rows, b = _rows(logdensity_fn, beta.shape), beta.reshape(-1)
    return lambda x: b * rows(x)


def pt_kernel(logdensity_fn: Callable, inner_kernel_fn: Callable, betas, noise=None):
    """Build a tempered step ``(generator, PTState) -> (PTState, PTInfo)``.

    ``inner_kernel_fn(beta, idx)`` returns a bundle whose kernel targets
    ``beta * logdensity`` on the flattened rows (module docstring);
    ``betas`` is the [T] inverse-temperature ladder, betas[0] == 1.  The
    swap uniforms [..., T-1] are drawn after the move, from ``gen`` or
    ``noise.uniform``.
    """

    def step(gen, state: PTState):
        xs, logps = state.xs, state.logps
        b = torch.as_tensor(betas, dtype=xs.dtype, device=xs.device)
        beta = b.expand(logps.shape)
        idx = torch.arange(b.shape[0], device=xs.device).expand(logps.shape)
        xs, logps = move(inner_kernel_fn(beta, idx), gen, xs, logps, beta)
        like = logps[..., :-1]
        u = (torch.rand(like.shape, generator=gen, dtype=xs.dtype, device=xs.device)
             if noise is None else noise.uniform(gen, like))
        xs, logps, accept, active = swap_sweep(xs, logps, b, state.even_phase, u)
        return (PTState(xs=xs, logps=logps, even_phase=not state.even_phase),
                PTInfo(swap_accept=accept, swap_active=active, logp_cold=logps[..., 0]))

    return step


def move(kern, gen, xs, logps, beta):
    """One inner-kernel move of every replica of ``xs`` [..., T, D] at its
    own ``beta`` [..., T], seeded with the carried untempered ``logps``.
    Returns the moved (xs, untempered logps)."""
    new, _ = kern.step(gen, kern.init(xs.reshape(-1, xs.shape[-1]), logps.reshape(-1)))
    lp = new.logp.reshape(logps.shape) / torch.clamp(beta, min=1e-12)
    return new.x.reshape(xs.shape), lp


def mh_at_beta(logdensity_fn, step_scales, noise=None):
    """Random-walk MH inner kernels.  ``init(x, logp_untempered)`` builds the
    state from the carried logp: zero extra density evaluations."""

    def factory(beta, idx):
        b = beta.reshape(-1)
        return KernelBundle(init=lambda x, lp: MHState(x=x, logp=b * lp),
                            step=mh_kernel(_tempered(logdensity_fn, beta), step_scales,
                                           chains=noise))

    return factory


def slice_at_beta(logdensity_fn, widths, noise=None, **kw):
    """Slice-sampling inner kernels (the reference's choice for quasar
    photo-z), on the port's lockstep ``slice_kernel``."""

    def factory(beta, idx):
        b = beta.reshape(-1)
        return KernelBundle(init=lambda x, lp: SliceState(x=x, logp=b * lp),
                            step=slice_kernel(_tempered(logdensity_fn, beta), widths,
                                              chains=noise, **kw))

    return factory


def tempered_step_size(step_size, beta):
    """``hmc_at_beta``'s step at inverse temperature ``beta``: inflated by
    beta^(-1/4), capped at 2x.  The likelihood flattens when hot but the
    priors still bound the posterior, so full 1/sqrt(beta) scaling
    overshoots and collapses hot-replica acceptance (breaking the ladder)."""
    return step_size * torch.clamp(torch.clamp(beta, min=1e-6) ** -0.25, max=2.0)


def _hmc_bundle(logdensity_fn, beta, step_size, inv_mass, n_leapfrog, noise):
    tempered, b = _tempered(logdensity_fn, beta), beta.reshape(-1)

    def init(x, lp):
        # the gradient of the tempered target, evaluated on entry: gradients
        # are not carried across swaps
        return HMCState(x=x, logp=b * lp, grad=value_and_grad(tempered, x)[1])

    return KernelBundle(init=init, step=hmc_kernel(tempered, step_size, inv_mass,
                                                   n_leapfrog=n_leapfrog, noise=noise))


def hmc_at_beta(logdensity_fn, step_size, inv_mass, n_leapfrog: int = 8, noise=None):
    """HMC inner kernels, the gradient upgrade of the reference's
    slice-within-tempering.  Hotter replicas see flatter posteriors, so the
    step inflates by beta^(-1/4), capped at 2x
    (``tempered_step_size``).  One gradient evaluation per move seeds the
    state."""

    def factory(beta, idx):
        eps = tempered_step_size(step_size, beta)
        return _hmc_bundle(logdensity_fn, beta, eps.reshape(-1), inv_mass, n_leapfrog, noise)

    return factory


def hmc_at_beta_adaptive(logdensity_fn, step_sizes, inv_masses, n_leapfrog: int = 8,
                         noise=None):
    """HMC inner kernels with per-replica adapted parameters (from
    ``pt_warmup``) instead of the capped beta^(-1/4) heuristic.

    ``step_sizes`` [..., T] and ``inv_masses`` [..., T, D] align with the
    ladder (leading axes broadcast to the rows'); each row takes its
    replica's slot ``idx``."""

    def factory(beta, idx):
        ss = torch.gather(torch.broadcast_to(step_sizes, idx.shape[:-1] + step_sizes.shape[-1:]),
                          -1, idx)
        d = inv_masses.shape[-1]
        full = torch.broadcast_to(inv_masses, idx.shape[:-1] + inv_masses.shape[-2:])
        im = torch.gather(full, -2, idx[..., None].expand(*idx.shape, d))
        return _hmc_bundle(logdensity_fn, beta, ss.reshape(-1), im.reshape(-1, d), n_leapfrog,
                           noise)

    return factory


def pt_warmup(gen, logdensity_fn, xs0, betas, n_warmup: int = 200, n_leapfrog: int = 8,
              noise=None):
    """Per-replica dual-averaging warmup for a tempered ladder: each replica
    of ``xs0`` [..., T, D] adapts its own HMC step size and diagonal mass
    against its tempered target (the port's per-chain ``hmc_warmup`` on the
    flattened rows).  Returns (xs [..., T, D], step_sizes [..., T],
    inv_masses [..., T, D]) ready for ``hmc_at_beta_adaptive`` and
    ``pt_init``."""
    shape = xs0.shape[:-1]
    beta = torch.as_tensor(betas, dtype=xs0.dtype, device=xs0.device).expand(shape)
    state, ss, im = hmc_warmup(gen, _tempered(logdensity_fn, beta),
                               xs0.reshape(-1, xs0.shape[-1]), n_warmup=n_warmup,
                               n_leapfrog=n_leapfrog, noise=noise)
    return state.x.reshape(xs0.shape), ss.reshape(shape), im.reshape(xs0.shape)


def geometric_ladder(n_temps: int, beta_min: float = 0.05, device="cpu"):
    """The geometric inverse-temperature ladder from 1 down to ``beta_min``
    [n_temps], computed in float32 as ``jnp.geomspace`` computes it."""
    f32 = dict(dtype=torch.float32, device=device)
    ten = torch.tensor(10.0, **f32)
    # log10 as jnp.log10 takes it: log(x) * float32(1 / log(10))
    inv_ln10 = torch.tensor(1.0 / 2.302585092994046, **f32)
    start = torch.log(torch.tensor(1.0, **f32)) * inv_ln10
    stop = torch.log(torch.tensor(float(beta_min), **f32)) * inv_ln10
    if n_temps == 1:
        return torch.pow(ten, start)[None]
    div = n_temps - 1
    step = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    lin = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return torch.pow(ten, lin)

