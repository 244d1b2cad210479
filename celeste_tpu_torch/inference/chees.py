"""ChEES-HMC: ensemble-adaptive jittered HMC (Hoffman, Radul & Sountsov,
AISTATS 2021), batch-major (counterpart of ``celeste_tpu/inference/chees.py``).

- One jittered trajectory length per step, shared by every chain, so the
  leapfrog loop runs exactly the realised number of steps for the whole
  ensemble at once.
- The trajectory length T adapts by Adam ascent on the ChEES criterion,
  estimated across the chain ensemble; the step size by dual averaging on
  the ensemble-mean acceptance.
- The jitter u_t is the base-2 Halton sequence, identical across chains.

States are [B, D] tensors on the log density's device.  The adaptation
scalars (dual averaging, Adam) are float32 0-d tensors on the host, as the
JAX package keeps them in float32: each warmup step brings the two
ensemble statistics it needs (mean acceptance, the ChEES gradient) to the
host in one transfer, and the leapfrog count of every step is computed on
the host, so sampling with frozen (eps, T) never waits on the device.

Sharded chains.  With ``chains`` (a ``parallel.ensemble.ChainShard``) the
states are this rank's rows of a larger ensemble: momenta and uniforms are
drawn at the ensemble's shape and sliced, and every cross-chain mean or sum
(the ChEES gradient's, the pooled acceptance, the divergence rate) is
reduced over the shard's group, so the ranks adapt one (eps, T) as one
process would.  Without it the code computes what it always has.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from celeste_tpu_torch.inference.hmc import value_and_grad

# energy error (nats) above which a proposal counts as diverged, as in NUTS
_DIVERGENCE_THRESHOLD = 1000.0


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _halton(i: int):
    """Base-2 Halton term ``i`` as a float32 0-d tensor: the 24-bit radical
    inverse of i + 1, exactly as the JAX package computes it."""
    x = (int(i) + 1) & 0xFFFFFFFF
    b = 0
    for _ in range(24):
        b = (b << 1) | (x & 1)
        x >>= 1
    return _f32(float(b)) / _f32(float(1 << 24))


class ChEESState(NamedTuple):
    xs: torch.Tensor          # [B, D]
    logps: torch.Tensor       # [B]
    grads: torch.Tensor       # [B, D]


class ChEESAdaptState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    da_t: torch.Tensor        # dual-averaging iteration
    da_gbar: torch.Tensor     # running acceptance error
    log_T: torch.Tensor       # trajectory length (time units)
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor


class ChEESInfo(NamedTuple):
    accept_rate: torch.Tensor
    n_leapfrog: torch.Tensor
    trajectory_length: torch.Tensor
    step_size: torch.Tensor
    divergence_rate: torch.Tensor   # fraction of chains whose proposal diverged


def chees_init(xs, logdensity_fn) -> ChEESState:
    logps, grads = value_and_grad(logdensity_fn, xs)
    return ChEESState(xs=xs, logps=logps, grads=grads)


def _ensemble_sum(x, chains, dim=None, keepdim=False):
    """``torch.sum`` over the chain axis (dim 0) of every rank's chains."""
    s = torch.sum(x) if dim is None else torch.sum(x, dim, keepdim=keepdim)
    return s if chains is None else chains.sum(s)


def _ensemble_mean(x, chains, dim=None, keepdim=False):
    """``torch.mean`` over the chain axis (dim 0) of every rank's chains."""
    if chains is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim, keepdim=keepdim)
    return _ensemble_sum(x, chains, dim, keepdim) / chains.n_global


def _ensemble_step(gen, state: ChEESState, logdensity_fn, eps: float, n_leap: int,
                   chains=None):
    """One jittered-HMC step of the whole ensemble (unit mass), ``n_leap``
    leapfrog steps of size ``eps`` shared by every chain."""
    xs = state.xs
    b = xs.shape[0]
    p0 = (torch.randn(xs.shape, generator=gen, dtype=xs.dtype, device=xs.device)
          if chains is None else chains.normal(gen, xs))
    energy0 = -state.logps + 0.5 * torch.sum(p0 * p0, dim=-1)
    x, p, logp, g = xs, p0, state.logps, state.grads
    for _ in range(n_leap):
        p_half = p + 0.5 * eps * g
        x = x + eps * p_half
        logp, g = value_and_grad(logdensity_fn, x)
        p = p_half + 0.5 * eps * g
    energy1 = -logp + 0.5 * torch.sum(p * p, dim=-1)
    # divergence: a non-finite or a large finite energy error (the NUTS
    # threshold, so that divergence rates compare across samplers)
    diverged = ~torch.isfinite(energy1) | (energy1 - energy0 > _DIVERGENCE_THRESHOLD)
    d_energy = torch.where(diverged, torch.full_like(energy0, -float("inf")), energy0 - energy1)
    accept_prob = torch.clamp(torch.exp(d_energy), max=1.0)
    u = (torch.rand(b, generator=gen, dtype=xs.dtype, device=xs.device) if chains is None
         else chains.uniform(gen, accept_prob))
    accept = u < accept_prob
    new = ChEESState(xs=torch.where(accept[:, None], x, xs),
                     logps=torch.where(accept, logp, state.logps),
                     grads=torch.where(accept[:, None], g, state.grads))
    # x and the velocity (unit mass: p) at the proposal end, for the ChEES gradient
    return new, accept_prob, x, p, diverged


def _chees_grad(xs, x1, v1, accept_prob, halved: float, chains=None):
    """d ChEES / d log T estimator pooled over chains: the accept-weighted
    mean of Delta <x' - mu', v'>.  Divergent proposals (non-finite x1 or v1,
    accept_prob 0) are masked before they enter a mean or a product."""
    finite = torch.isfinite(torch.sum(x1, -1) + torch.sum(v1, -1))
    x1 = torch.where(finite[:, None], x1, xs)
    v1 = torch.where(finite[:, None], v1, torch.zeros_like(v1))
    w_raw = torch.where(finite, accept_prob, torch.zeros_like(accept_prob))
    mu0 = _ensemble_mean(xs, chains, 0, keepdim=True)
    mu1 = (_ensemble_sum(torch.where(finite[:, None], x1, torch.zeros_like(x1)), chains, 0,
                         keepdim=True)
           / torch.clamp(_ensemble_sum(finite, chains), min=1))
    delta = torch.sum((x1 - mu1) ** 2, -1) - torch.sum((xs - mu0) ** 2, -1)
    term = delta * torch.sum((x1 - mu1) * v1, -1)
    w = w_raw / torch.clamp(_ensemble_sum(w_raw, chains), min=1e-6)
    return _ensemble_sum(w * term, chains) * halved


def chees_warmup_init(xs0, logdensity_fn, init_step_size: float = 0.1,
                      init_trajectory: float = 1.0):
    """Start the windowed ChEES warmup: the (state, adapt) carry that
    ``chees_warmup_window`` advances."""
    log_eps = torch.log(_f32(init_step_size))
    adapt = ChEESAdaptState(log_eps=log_eps, log_eps_avg=log_eps.clone(), da_t=_f32(0.0),
                            da_gbar=_f32(0.0), log_T=torch.log(_f32(init_trajectory)),
                            adam_m=_f32(0.0), adam_v=_f32(0.0), adam_t=_f32(0.0))
    return chees_init(xs0, logdensity_fn), adapt


def chees_warmup_window(gen, logdensity_fn, carry, n_iters: int, init_step_size: float = 0.1,
                        target_accept: float = 0.651, max_leapfrog: int = 256,
                        adam_lr: float = 0.025, chains=None):
    """Advance the warmup ``n_iters`` steps.  The Halton and dual-averaging
    index rides in the carry (``da_t``), so windows compose: two windows on
    one generator equal one window of their summed length, bitwise.
    ``init_step_size`` must match the init call (it anchors the
    dual-averaging prior mean mu = log(10 eps0)).  ``chains``: this rank's
    shard of a sharded ensemble (module docstring)."""
    state, ad = carry
    mu = torch.log(_f32(10.0 * init_step_size))
    for _ in range(n_iters):
        u = _halton(int(ad.da_t))
        eps = torch.exp(ad.log_eps)
        n_leap = max(1, int(torch.round(u * torch.exp(ad.log_T) / eps)))
        halved = 0.0 if n_leap > max_leapfrog else 1.0
        new, accept_prob, x1, v1, _ = _ensemble_step(gen, state, logdensity_fn, float(eps),
                                                     min(n_leap, max_leapfrog), chains)
        acc, grad = torch.stack([
            _ensemble_mean(accept_prob, chains),
            _chees_grad(state.xs, x1, v1, accept_prob, halved, chains)]).cpu()
        # dual averaging on the pooled acceptance (Nesterov / Stan schedule)
        t = ad.da_t + 1.0
        gbar = (1.0 - 1.0 / (t + 10.0)) * ad.da_gbar + (target_accept - acc) / (t + 10.0)
        log_eps = mu - torch.sqrt(t) / 0.05 * gbar
        w = t ** -0.75
        log_eps_avg = w * log_eps + (1.0 - w) * ad.log_eps_avg
        # Adam ascent on dChEES / dlog T (the gradient wrt T times T)
        g_t = grad * torch.exp(ad.log_T) * u
        g_t = torch.where(torch.isfinite(g_t), g_t, _f32(0.0))
        at = ad.adam_t + 1.0
        m = 0.9 * ad.adam_m + 0.1 * g_t
        v = 0.999 * ad.adam_v + 0.001 * g_t * g_t
        mhat = m / (1.0 - 0.9 ** at)
        vhat = v / (1.0 - 0.999 ** at)
        log_t = ad.log_T + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
        # keep T within [eps, eps * max_leapfrog]
        log_t = torch.clamp(log_t, torch.log(eps), torch.log(eps * max_leapfrog))
        state = new
        ad = ChEESAdaptState(log_eps=log_eps, log_eps_avg=log_eps_avg, da_t=t, da_gbar=gbar,
                             log_T=log_t, adam_m=m, adam_v=v, adam_t=at)
    return state, ad


def chees_warmup_finish(carry):
    """(ChEESState, adapted step size, adapted trajectory length)."""
    state, ad = carry
    return state, torch.exp(ad.log_eps_avg), torch.exp(ad.log_T)


def chees_warmup(gen, logdensity_fn, xs0, n_warmup: int = 200, init_step_size: float = 0.1,
                 init_trajectory: float = 1.0, target_accept: float = 0.651,
                 max_leapfrog: int = 256, adam_lr: float = 0.025, chains=None):
    """Joint (eps, T) adaptation on the ensemble, unit mass (run it in the
    whitened space for correlated targets).  Returns (ChEESState, step size,
    trajectory length)."""
    carry = chees_warmup_init(xs0, logdensity_fn, init_step_size, init_trajectory)
    carry = chees_warmup_window(gen, logdensity_fn, carry, n_warmup,
                                init_step_size=init_step_size, target_accept=target_accept,
                                max_leapfrog=max_leapfrog, adam_lr=adam_lr, chains=chains)
    return chees_warmup_finish(carry)


def run_chees_ensemble(gen, logdensity_fn, state: ChEESState, n_steps: int, step_size,
                       trajectory_length, max_leapfrog: int = 256, start_iter: int = 0,
                       chains=None):
    """Sample with frozen (eps, T), jittered per step by the Halton term of
    the global step index ``start_iter + i`` (so that segments continue the
    sequence).  Returns (samples [B, n_steps, D], final state, ChEESInfo of
    per-step ensemble means, each [n_steps]); with ``chains``, this rank's
    samples and means over every rank's chains."""
    eps = _f32(float(step_size))
    traj = _f32(float(trajectory_length))
    device = state.xs.device
    samples, accept, leaps, diverged = [], [], [], []
    for i in range(n_steps):
        u = _halton(start_iter + i)
        n_leap = min(max(int(torch.round(u * traj / eps)), 1), max_leapfrog)
        state, accept_prob, _, _, div = _ensemble_step(gen, state, logdensity_fn, float(eps),
                                                       n_leap, chains)
        samples.append(state.xs)
        accept.append(_ensemble_mean(accept_prob, chains))
        diverged.append(_ensemble_mean(div.to(accept_prob.dtype), chains))
        leaps.append(n_leap)
    n_leapfrog = torch.tensor(leaps, dtype=torch.int32, device=device)
    info = ChEESInfo(accept_rate=torch.stack(accept), n_leapfrog=n_leapfrog,
                     trajectory_length=eps.to(device) * n_leapfrog.to(torch.float32),
                     step_size=eps.to(device).expand(n_steps),
                     divergence_rate=torch.stack(diverged))
    return torch.stack(samples, dim=1), state, info

