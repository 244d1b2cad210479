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

Groups.  The states are G independent ensembles of B chains each, stacked
set-major as [G B, D] rows (group g's chains are rows g B .. g B + B - 1),
described by a :class:`Groups`: each group has its own step size and
trajectory length, its own dual-averaging and Adam state, its own means
and sums over its chains, and its own random stream.  A step's leapfrog
loop runs to the largest group's count, and a group's x and p stay frozen
once it has done its own.  The field pipeline samples its fit groups so
(``groups=``).  The single ensemble is the case G = 1 (``gen``, and the
adaptation scalars 0-d tensors), the path every other sampler takes.

Sharded chains.  With ``chains`` (a ``parallel.ensemble.ChainShard``) the
single ensemble's states are this rank's rows of a larger one: momenta and
uniforms are drawn at the ensemble's shape and sliced, and every
cross-chain mean or sum (the ChEES gradient's, the pooled acceptance, the
divergence rate) is reduced over the shard's group, so the ranks adapt one
(eps, T) as one process would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from celeste_tpu_torch.inference.hmc import value_and_grad
from celeste_tpu_torch.inference.type_switch import CandidateStreams
from celeste_tpu_torch.utils.profiling import span

# energy error (nats) above which a proposal counts as diverged, as in NUTS
_DIVERGENCE_THRESHOLD = 1000.0


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


class Groups(CandidateStreams):
    """G independent chain ensembles of ``n_chains`` each, stacked
    set-major; group g draws its momenta and uniforms from ``gens[g]`` alone
    (``normal(None, like)``, ``uniform(None, like)``), so its draws depend
    on neither the batch of groups nor the rank that holds it."""

    def __init__(self, gens, n_chains: int):
        super().__init__(gens)
        self.n = len(self.gens)
        self.b = int(n_chains)

    def view(self, x):
        """[G B, ...] -> [G, B, ...]."""
        return x.reshape((self.n, self.b) + tuple(x.shape[1:]))

    def rows(self, v):
        """A per-group [G] tensor -> per-row [G B] on ``v``'s device."""
        return v[:, None].expand(-1, self.b).reshape(-1)

    def sum(self, x, keepdim=False):
        """Each group's sum over its chains of rows ``x`` [G B, ...]: [G, ...]."""
        return torch.sum(self.view(x), 1, keepdim=keepdim)

    def mean(self, x, keepdim=False):
        """Each group's mean over its chains, as :meth:`sum`."""
        return torch.mean(self.view(x), 1, keepdim=keepdim)


class _ShardedEnsemble(Groups):
    """One ensemble whose chains are sharded over ranks: this rank's rows
    draw their slice of the whole ensemble's draws from ``gen``, and every
    sum and mean runs over every rank's chains."""

    def __init__(self, gen, chains, n_local: int):
        super().__init__([gen], n_local)
        self.chains = chains

    def normal(self, gen, like):
        return self.chains.normal(self.gens[0], like)

    def uniform(self, gen, like):
        return self.chains.uniform(self.gens[0], like)

    def sum(self, x, keepdim=False):
        return self.chains.sum(super().sum(x, keepdim))

    def mean(self, x, keepdim=False):
        return self.sum(x, keepdim) / self.chains.n_global


def _ensembles(gen, chains, groups, n_rows: int) -> Groups:
    """The :class:`Groups` a call samples: ``groups`` itself, or the single
    ensemble of ``n_rows`` chains drawing from ``gen`` (sharded by
    ``chains``)."""
    if groups is not None:
        if chains is not None:
            raise ValueError("groups and sharded chains do not combine: shard the groups")
        return groups
    return Groups([gen], n_rows) if chains is None else _ShardedEnsemble(gen, chains, n_rows)


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


def _row_step_sizes(eps, ens: Groups, device):
    """The step sizes ``eps`` ([G] or 0-d, on the host) by row, for
    :func:`_ensemble_step`: one ensemble's stays a 0-d host tensor, which
    the device's kernels take as a scalar (no transfer, so sampling never
    waits on the device); G groups' is [G B, 1] on ``device``."""
    if ens.n == 1:
        return eps.reshape(())
    return ens.rows(eps.to(device))[:, None]


def _ensemble_step(state: ChEESState, logdensity_fn, h, n_leap, ens: Groups):
    """One jittered-HMC step of every ensemble (unit mass): group g runs
    ``n_leap[g]`` leapfrog steps of its size in ``h``
    (:func:`_row_step_sizes`), the loop max(n_leap) steps with each
    group's x and p stopped after its own count."""
    with span("sampler.step"):
        xs = state.xs
        p0 = ens.normal(None, xs)
        half_h = 0.5 * h
        energy0 = -state.logps + 0.5 * torch.sum(p0 * p0, dim=-1)
        x, p, logp, g = xs, p0, state.logps, state.grads
        for k in range(max(n_leap)):
            p_half = p + half_h * g
            x_new = x + h * p_half
            logp_new, g_new = value_and_grad(logdensity_fn, x_new)
            p_new = p_half + half_h * g_new
            if min(n_leap) > k:
                x, p, logp, g = x_new, p_new, logp_new, g_new
            else:
                # groups past their own count keep their end point
                live = ens.rows(torch.tensor([n > k for n in n_leap], device=xs.device))
                x = torch.where(live[:, None], x_new, x)
                p = torch.where(live[:, None], p_new, p)
                logp = torch.where(live, logp_new, logp)
                g = torch.where(live[:, None], g_new, g)
        energy1 = -logp + 0.5 * torch.sum(p * p, dim=-1)
        # divergence: a non-finite or a large finite energy error (the NUTS
        # threshold, so that divergence rates compare across samplers)
        diverged = ~torch.isfinite(energy1) | (energy1 - energy0 > _DIVERGENCE_THRESHOLD)
        d_energy = torch.where(diverged, torch.full_like(energy0, -float("inf")),
                               energy0 - energy1)
        accept_prob = torch.clamp(torch.exp(d_energy), max=1.0)
        accept = ens.uniform(None, accept_prob) < accept_prob
        new = ChEESState(xs=torch.where(accept[:, None], x, xs),
                         logps=torch.where(accept, logp, state.logps),
                         grads=torch.where(accept[:, None], g, state.grads))
        # x and the velocity (unit mass: p) at the proposal end, for the ChEES gradient
        return new, accept_prob, x, p, diverged


def _chees_grad(xs, x1, v1, accept_prob, ens: Groups):
    """d ChEES / d log T estimator of each group pooled over its chains,
    [G]: the accept-weighted mean of Delta <x' - mu', v'>.  Divergent
    proposals (non-finite x1 or v1, accept_prob 0) are masked before they
    enter a mean or a product."""
    finite = torch.isfinite(torch.sum(x1, -1) + torch.sum(v1, -1))
    x1 = torch.where(finite[:, None], x1, xs)
    v1 = torch.where(finite[:, None], v1, torch.zeros_like(v1))
    w_raw = torch.where(finite, accept_prob, torch.zeros_like(accept_prob))
    mu0 = ens.mean(xs, keepdim=True)
    mu1 = (ens.sum(torch.where(finite[:, None], x1, torch.zeros_like(x1)), keepdim=True)
           / torch.clamp(ens.sum(finite), min=1)[:, None, None])
    xs, x1, v1 = ens.view(xs), ens.view(x1), ens.view(v1)
    delta = torch.sum((x1 - mu1) ** 2, -1) - torch.sum((xs - mu0) ** 2, -1)
    term = delta * torch.sum((x1 - mu1) * v1, -1)
    w = ens.view(w_raw) / torch.clamp(ens.sum(w_raw, keepdim=True), min=1e-6)
    return ens.sum((w * term).reshape(-1))


def chees_warmup_init(xs0, logdensity_fn, init_step_size: float = 0.1,
                      init_trajectory: float = 1.0, groups=None):
    """Start the windowed ChEES warmup: the (state, adapt) carry that
    ``chees_warmup_window`` advances; with ``groups`` every adaptation
    scalar is a [G] tensor, one per group."""
    shape = () if groups is None else (groups.n,)

    def full(v):
        return torch.full(shape, float(v), dtype=torch.float32)

    log_eps = torch.log(full(init_step_size))
    adapt = ChEESAdaptState(log_eps=log_eps, log_eps_avg=log_eps.clone(), da_t=full(0.0),
                            da_gbar=full(0.0), log_T=torch.log(full(init_trajectory)),
                            adam_m=full(0.0), adam_v=full(0.0), adam_t=full(0.0))
    return chees_init(xs0, logdensity_fn), adapt


def chees_warmup_window(gen, logdensity_fn, carry, n_iters: int, init_step_size: float = 0.1,
                        target_accept: float = 0.651, max_leapfrog: int = 256,
                        adam_lr: float = 0.025, chains=None, groups=None):
    """Advance the warmup ``n_iters`` steps.  The Halton and dual-averaging
    index rides in the carry (``da_t``), so windows compose: two windows on
    one generator equal one window of their summed length, bitwise.
    ``init_step_size`` must match the init call (it anchors the
    dual-averaging prior mean mu = log(10 eps0)).  ``chains``: this rank's
    shard of a sharded ensemble; ``groups``: G ensembles adapted each on
    its own (module docstring; ``gen`` is then unused)."""
    state, ad = carry
    ens = _ensembles(gen, chains, groups, state.xs.shape[0])
    mu = torch.log(_f32(10.0 * init_step_size))
    for _ in range(n_iters):
        u = _halton(int(ad.da_t.reshape(-1)[0]))
        eps = torch.exp(ad.log_eps)
        n_leap = torch.clamp(torch.round(u * torch.exp(ad.log_T) / eps), min=1).reshape(-1)
        halved = (n_leap <= max_leapfrog).to(torch.float32).reshape(eps.shape)
        new, accept_prob, x1, v1, _ = _ensemble_step(
            state, logdensity_fn, _row_step_sizes(eps, ens, state.xs.device),
            [min(int(n), max_leapfrog) for n in n_leap.tolist()], ens)
        acc, grad = torch.stack([ens.mean(accept_prob),
                                 _chees_grad(state.xs, x1, v1, accept_prob, ens)]).cpu()
        acc, grad = acc.reshape(eps.shape), grad.reshape(eps.shape) * halved
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
                 max_leapfrog: int = 256, adam_lr: float = 0.025, chains=None, groups=None):
    """Joint (eps, T) adaptation on the ensemble, unit mass (run it in the
    whitened space for correlated targets).  Returns (ChEESState, step size,
    trajectory length); with ``groups`` both are [G] tensors."""
    carry = chees_warmup_init(xs0, logdensity_fn, init_step_size, init_trajectory, groups)
    carry = chees_warmup_window(gen, logdensity_fn, carry, n_warmup,
                                init_step_size=init_step_size, target_accept=target_accept,
                                max_leapfrog=max_leapfrog, adam_lr=adam_lr, chains=chains,
                                groups=groups)
    return chees_warmup_finish(carry)


def run_chees_ensemble(gen, logdensity_fn, state: ChEESState, n_steps: int, step_size,
                       trajectory_length, max_leapfrog: int = 256, start_iter: int = 0,
                       chains=None, groups=None):
    """Sample with frozen (eps, T), jittered per step by the Halton term of
    the global step index ``start_iter + i`` (so that segments continue the
    sequence).  Returns (samples [B, n_steps, D], final state, ChEESInfo of
    per-step ensemble means, each [n_steps]); with ``chains``, this rank's
    samples and means over every rank's chains; with ``groups``, (eps, T)
    are [G] and every info field is [G, n_steps], each group's means over
    its own chains."""
    ens = _ensembles(gen, chains, groups, state.xs.shape[0])
    eps = torch.as_tensor(step_size, dtype=torch.float32).cpu()
    traj = torch.as_tensor(trajectory_length, dtype=torch.float32).cpu()
    device = state.xs.device
    h = _row_step_sizes(eps, ens, device)
    samples, accept, leaps, diverged = [], [], [], []
    for i in range(n_steps):
        u = _halton(start_iter + i)
        n_leap = torch.clamp(torch.round(u * traj / eps), 1, max_leapfrog).to(torch.int32)
        n_leap = n_leap.reshape(-1)
        state, accept_prob, _, _, div = _ensemble_step(state, logdensity_fn, h, n_leap.tolist(),
                                                       ens)
        samples.append(state.xs)
        accept.append(ens.mean(accept_prob))
        diverged.append(ens.mean(div.to(accept_prob.dtype)))
        leaps.append(n_leap)
    n_leapfrog = torch.stack(leaps, dim=1).to(device)
    eps_d = eps.reshape(-1).to(device)[:, None]
    info = ChEESInfo(accept_rate=torch.stack(accept, dim=1), n_leapfrog=n_leapfrog,
                     trajectory_length=eps_d * n_leapfrog.to(torch.float32),
                     step_size=eps_d.expand(ens.n, n_steps),
                     divergence_rate=torch.stack(diverged, dim=1))
    if groups is None:
        info = ChEESInfo(*(t[0] for t in info))
    return torch.stack(samples, dim=1), state, info
