"""Hamiltonian Monte Carlo with dual-averaging step size and diagonal
mass-matrix adaptation, batch-major (counterpart of
``celeste_tpu/inference/hmc.py``).

Every state holds all chains: ``x`` [B, D], ``logp`` [B], ``grad`` [B, D].
Chains are independent, so one ``torch.autograd.grad`` of ``logp.sum()``
gives every chain's exact gradient at once.  Leapfrog and warmup are Python
loops.  Warmup adapts one step size per chain ([B]) and one diagonal mass
per chain ([B, D]), exactly as the per-chain JAX warmup does when it is
mapped over chains.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class HMCState(NamedTuple):
    x: torch.Tensor       # [B, D]
    logp: torch.Tensor    # [B]
    grad: torch.Tensor    # [B, D] cached gradient of logp at x


class HMCInfo(NamedTuple):
    accepted: torch.Tensor
    accept_prob: torch.Tensor
    logp: torch.Tensor
    energy_error: torch.Tensor


def value_and_grad(logdensity_fn, x):
    """(logp [B], d logp / dx [B, D]) of a batched log density."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        logp = logdensity_fn(xr)
        (grad,) = torch.autograd.grad(logp.sum(), xr)
    return logp.detach(), grad


def hmc_init(x0, logdensity_fn) -> HMCState:
    logp, grad = value_and_grad(logdensity_fn, x0)
    return HMCState(x=x0, logp=logp, grad=grad)


def _per_chain(step_size, x):
    """A scalar or [B] step size as a [B, 1] column."""
    s = torch.as_tensor(step_size, dtype=x.dtype, device=x.device)
    return s.reshape(-1, 1) if s.dim() > 0 else s


def _leapfrog(logdensity_fn, x, p, grad, step_size, inv_mass, n_steps):
    """Fixed-length leapfrog integrator; returns final (x, p, logp, grad)."""
    logp = None
    for _ in range(n_steps):
        p_half = p + 0.5 * step_size * grad
        x = x + step_size * inv_mass * p_half
        logp, grad = value_and_grad(logdensity_fn, x)
        p = p_half + 0.5 * step_size * grad
    return x, p, logp, grad


def _hmc_step(gen, logdensity_fn, state: HMCState, step_size, inv_mass, n_leapfrog):
    """One HMC transition of every chain; ``step_size`` is a scalar or
    [B, 1], ``inv_mass`` [D] or [B, D]."""
    x = state.x
    sqrt_mass = 1.0 / torch.sqrt(inv_mass)
    p0 = sqrt_mass * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    energy0 = -state.logp + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    x1, p1, logp1, grad1 = _leapfrog(logdensity_fn, x, p0, state.grad, step_size,
                                     inv_mass, n_leapfrog)
    energy1 = -logp1 + 0.5 * torch.sum(inv_mass * p1 * p1, dim=-1)
    d_energy = energy0 - energy1
    d_energy = torch.where(torch.isfinite(d_energy), d_energy,
                           torch.full_like(d_energy, -float("inf")))
    accept_prob = torch.clamp(torch.exp(d_energy), max=1.0)
    u = torch.rand(x.shape[0], generator=gen, dtype=x.dtype, device=x.device)
    accept = u < accept_prob
    new = HMCState(
        x=torch.where(accept[:, None], x1, x),
        logp=torch.where(accept, logp1, state.logp),
        grad=torch.where(accept[:, None], grad1, state.grad),
    )
    return new, HMCInfo(accepted=accept, accept_prob=accept_prob, logp=new.logp,
                        energy_error=-d_energy)


def hmc_kernel(logdensity_fn, step_size, inv_mass, n_leapfrog: int = 16):
    """Build an HMC step ``(generator, state) -> (state, info)``.
    ``inv_mass`` is the [D] (or per-chain [B, D]) diagonal inverse mass;
    ``step_size`` a scalar or a per-chain [B] tensor."""

    def step(gen, state: HMCState):
        eps = _per_chain(step_size, state.x)
        im = torch.as_tensor(inv_mass, dtype=state.x.dtype, device=state.x.device)
        return _hmc_step(gen, logdensity_fn, state, eps, im, n_leapfrog)

    return step


# ---------------------------------------------------------------------------
# Warmup: dual averaging + Welford diagonal mass, one of each per chain
# ---------------------------------------------------------------------------

class DualAveragingState(NamedTuple):
    log_step: torch.Tensor        # [B]
    log_step_avg: torch.Tensor    # [B]
    h_avg: torch.Tensor           # [B]
    mu: torch.Tensor              # [B]
    t: float


def da_init(step_size0):
    ls = torch.log(step_size0)
    return DualAveragingState(log_step=ls, log_step_avg=ls, h_avg=torch.zeros_like(ls),
                              mu=math.log(10.0) + ls, t=0.0)


def da_update(da: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75):
    t = da.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * da.h_avg + (target - accept_prob) / (t + t0)
    log_step = da.mu - t ** 0.5 / gamma * h_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * da.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_avg, da.mu, t)


class WelfordState(NamedTuple):
    mean: torch.Tensor    # [B, D]
    m2: torch.Tensor      # [B, D]
    count: float


def welford_init(x):
    return WelfordState(torch.zeros_like(x), torch.zeros_like(x), 0.0)


def welford_update(w: WelfordState, x):
    count = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / count
    m2 = w.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(w: WelfordState, reg: float = 1e-3):
    var = w.m2 / max(w.count - 1.0, 1.0)
    # Stan-style shrinkage toward unit scale for small counts
    shrink = w.count / (w.count + 5.0)
    return shrink * var + reg * (1.0 - shrink) + 1e-7


class WarmupCarry(NamedTuple):
    state: HMCState
    da: DualAveragingState
    wf: WelfordState
    inv_mass: torch.Tensor    # [B, D]
    t: int


def hmc_warmup_init(x0, logdensity_fn, init_step_size: float = 0.1) -> WarmupCarry:
    """Warmup carry for ``hmc_warmup_window``: the HMC state, per-chain
    dual-averaging and Welford states, per-chain inverse mass, step count."""
    step0 = torch.full((x0.shape[0],), init_step_size, dtype=x0.dtype, device=x0.device)
    return WarmupCarry(hmc_init(x0, logdensity_fn), da_init(step0), welford_init(x0),
                       torch.ones_like(x0), 0)


def hmc_warmup_window(gen, logdensity_fn, carry: WarmupCarry, n_steps: int,
                      n_warmup: int, n_leapfrog: int = 16,
                      target_accept: float = 0.8) -> WarmupCarry:
    """Advance the adaptive warmup by ``n_steps`` steps.  ``n_warmup`` is the
    TOTAL planned warmup length (the mass-adaptation window is phased on
    it), so chaining windows equals one ``hmc_warmup`` call."""
    state, da, wf, inv_mass, t = carry
    for _ in range(n_steps):
        eps = torch.exp(da.log_step)[:, None]
        state, info = _hmc_step(gen, logdensity_fn, state, eps, inv_mass, n_leapfrog)
        da = da_update(da, info.accept_prob, target=target_accept)
        # mass adaptation window: second half of warmup, frozen for the last 10%
        if n_warmup // 2 <= t < int(n_warmup * 0.9):
            wf = welford_update(wf, state.x)
        # refresh the estimate once the window has data; before, it stays ones
        if wf.count > 10.0:
            inv_mass = welford_variance(wf)
        t += 1
    return WarmupCarry(state, da, wf, inv_mass, t)


def hmc_warmup_finish(carry: WarmupCarry):
    """(final HMCState, adapted step sizes [B], inv_mass [B, D])."""
    return carry.state, torch.exp(carry.da.log_step_avg), carry.inv_mass


def hmc_warmup(gen, logdensity_fn, x0, n_warmup: int = 500, n_leapfrog: int = 16,
               init_step_size: float = 0.1, target_accept: float = 0.8):
    """Adaptive warmup of every chain: dual averaging of each chain's step
    size at every step, Welford diagonal mass over the second half.
    Returns (final HMCState, step sizes [B], inv_mass [B, D])."""
    carry = hmc_warmup_init(x0, logdensity_fn, init_step_size)
    carry = hmc_warmup_window(gen, logdensity_fn, carry, n_warmup, n_warmup, n_leapfrog,
                              target_accept)
    return hmc_warmup_finish(carry)
