"""Within-MCMC star<->galaxy type switching (counterpart of
``celeste_tpu/inference/type_switch.py``): the Carlin & Chib (1995)
composite-model sampler, which carries both parameter blocks at all times,

    p(a, x_s, x_g | data)  ∝  p(a) · L_a(data | x_a) · pi_a(x_a)
                                   · psi_{~a}(x_{~a}),

where psi_k is the Gaussian pseudo-prior of the inactive block.  Each sweep:

  1. active block  <- one HMC step w.r.t. its posterior conditional;
  2. inactive block <- exact draw from its pseudo-prior;
  3. a <- Bernoulli on the marginal log-odds
         [logp_s(x_s) - psi_s(x_s)] - [logp_g(x_g) - psi_g(x_g)] + prior.

Both blocks advance every step and the indicator selects per row.  psi is
the MAP + Laplace Gaussian of each model (``model_select.hessian_fd``).

Batch-major over candidates x chains: row r of a state belongs to
candidate r // n_chains, and the log densities take rows grouped that way
(any number of rows per candidate), as the pipeline's conditional
posteriors do.  ``CandidateStreams`` draws each candidate's numbers from its
own generator, so which other candidates share the batch changes none of
its random numbers.  Its P(star) is then the same bitwise where the log
density of a row does not depend on the batch's size, as with the plain
stamp kernel on the CPU.  On the card K1 picks its pixel split from the row
count, so a row's float32 sums, and after many HMC steps its chain, differ
with the batch: there P(star) is the same in distribution only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from celeste_tpu_torch.inference.hmc import HMCState, hmc_init, hmc_kernel
from celeste_tpu_torch.inference.map_fit import map_fit
from celeste_tpu_torch.inference.model_select import LOG_2PI, hessian_fd


class CandidateStreams:
    """The random numbers of a batch of candidates' chains, each
    candidate's from its own generator, in the ``noise`` protocol of
    ``hmc_kernel``: ``normal(gen, like)`` and ``uniform(gen, like)`` return
    a tensor shaped as ``like`` (``gen`` unused) whose rows are grouped by
    candidate, each group drawn from that candidate's generator."""

    def __init__(self, gens):
        self.gens = list(gens)

    def _draw(self, fn, like):
        shape = (like.shape[0] // len(self.gens),) + tuple(like.shape[1:])
        draws = [fn(shape, generator=g, dtype=like.dtype, device=like.device)
                 for g in self.gens]
        return draws[0] if len(draws) == 1 else torch.cat(draws)

    def normal(self, gen, like):
        return self._draw(torch.randn, like)

    def uniform(self, gen, like):
        return self._draw(torch.rand, like)


class GaussianPseudoPrior(NamedTuple):
    """Dense Gaussians psi(x) = N(mean, L L^T), one per row."""
    mean: torch.Tensor        # [M, D]
    chol: torch.Tensor        # [M, D, D] lower
    logdet_cov: torch.Tensor  # [M]: log det(cov)

    def logpdf(self, x):
        """[M] log densities of ``x`` [M, D]."""
        d = x.shape[-1]
        z = torch.linalg.solve_triangular(self.chol, (x - self.mean)[..., None],
                                          upper=False)[..., 0]
        return -0.5 * torch.sum(z * z, -1) - 0.5 * (d * LOG_2PI + self.logdet_cov)

    def sample(self, gen, noise=None):
        """One draw per row, [M, D]; ``noise`` as in ``hmc_kernel``."""
        z = (torch.randn(self.mean.shape, generator=gen, dtype=self.mean.dtype,
                         device=self.mean.device) if noise is None
             else noise.normal(gen, self.mean))
        return self.mean + (self.chol @ z[..., None])[..., 0]

    def rows(self, k: int) -> "GaussianPseudoPrior":
        """Each row repeated k times in place (candidate-major rows)."""
        return GaussianPseudoPrior(*(t.repeat_interleave(k, dim=0) for t in self))


def fit_pseudo_prior(logdensity_fn, x0, n_map_steps: int = 400, jitter: float = 1e-5):
    """Laplace fit psi ~= posterior of one model for each row of ``x0``
    [N, D]: MAP by Adam, covariance = inverse negative Hessian with its
    spectrum floored at ``jitter`` (a poorly converged or boundary MAP can
    leave -H indefinite; the floored directions just get wide).  Returns the
    pseudo-prior and the Laplace log-evidence [N] from the same spectrum.

    ``logdet_cov`` comes from the chol actually sampled with, so logpdf and
    sample describe one Gaussian and the indicator odds carry no bias.  The
    eigendecomposition and the Cholesky factor are taken in float64 and
    returned in float32."""
    x_map, _ = map_fit(logdensity_fn, x0, n_steps=n_map_steps)
    logp, h = hessian_fd(logdensity_fn, x_map)
    d = x_map.shape[-1]
    evals, evecs = torch.linalg.eigh(-h.double())
    evals = torch.clamp(evals, min=jitter)
    cov = (evecs * (1.0 / evals)[..., None, :]) @ evecs.transpose(-1, -2)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    chol = torch.linalg.cholesky(cov)
    logdet_cov = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
    pseudo = GaussianPseudoPrior(mean=x_map, chol=chol.to(x_map.dtype),
                                 logdet_cov=logdet_cov.to(x_map.dtype))
    evidence = logp.double() + 0.5 * d * LOG_2PI - 0.5 * torch.sum(torch.log(evals), -1)
    return pseudo, evidence.to(logp.dtype)


class TypeSwitchState(NamedTuple):
    a: torch.Tensor        # [B] int32: 0 = star, 1 = galaxy
    star: HMCState         # star-block HMC state, [B, Ds]
    gal: HMCState          # galaxy-block HMC state, [B, Dg]


class TypeSwitchInfo(NamedTuple):
    p_star_cond: torch.Tensor   # [B] conditional P(a=star | blocks) this step
    accept_star: torch.Tensor   # [B] star-block HMC accept prob
    accept_gal: torch.Tensor    # [B]


def type_switch_init(x0_star, x0_gal, logd_star, logd_gal, a0: int = 0) -> TypeSwitchState:
    return TypeSwitchState(
        a=torch.full((x0_star.shape[0],), a0, dtype=torch.int32, device=x0_star.device),
        star=hmc_init(x0_star, logd_star),
        gal=hmc_init(x0_gal, logd_gal))


def _select(pred, a: HMCState, b: HMCState) -> HMCState:
    return HMCState(*(torch.where(pred.reshape((-1,) + (1,) * (u.dim() - 1)), u, v)
                      for u, v in zip(a, b)))


def type_switch_kernel(logd_star, logd_gal, pseudo_star: GaussianPseudoPrior,
                       pseudo_gal: GaussianPseudoPrior, step_size_star, step_size_gal,
                       n_leapfrog: int = 8, prior_star: float = 0.5, noise=None):
    """Build the Carlin-Chib sweep ``(generator, state) -> (state, info)``.

    ``pseudo_*`` hold one Gaussian per row of the state.  ``step_size_*``:
    HMC step sizes (scalar or [B]); the inverse mass of each row is its
    pseudo-prior's diagonal covariance.  ``noise`` as in ``hmc_kernel``
    (``CandidateStreams`` for per-candidate streams)."""
    hmc_s = hmc_kernel(logd_star, step_size_star, torch.sum(pseudo_star.chol ** 2, -1),
                       n_leapfrog=n_leapfrog, noise=noise)
    hmc_g = hmc_kernel(logd_gal, step_size_gal, torch.sum(pseudo_gal.chol ** 2, -1),
                       n_leapfrog=n_leapfrog, noise=noise)
    log_prior_odds = math.log(prior_star) - math.log1p(-prior_star)

    def step(gen, state: TypeSwitchState):
        is_star = state.a == 0
        # 1+2. both blocks advance every step; the indicator picks posterior
        # HMC for the active block and a pseudo-prior refresh for the other
        star_hmc, info_s = hmc_s(gen, state.star)
        gal_hmc, info_g = hmc_g(gen, state.gal)
        star_pseudo = hmc_init(pseudo_star.sample(gen, noise), logd_star)
        gal_pseudo = hmc_init(pseudo_gal.sample(gen, noise), logd_gal)
        star_new = _select(is_star, star_hmc, star_pseudo)
        gal_new = _select(is_star, gal_pseudo, gal_hmc)

        # 3. Gibbs update of the indicator given both blocks
        log_odds = ((star_new.logp - pseudo_star.logpdf(star_new.x))
                    - (gal_new.logp - pseudo_gal.logpdf(gal_new.x)) + log_prior_odds)
        p_star_cond = torch.sigmoid(log_odds)
        u = (torch.rand(p_star_cond.shape, generator=gen, dtype=p_star_cond.dtype,
                        device=p_star_cond.device) if noise is None
             else noise.uniform(gen, p_star_cond))
        a_new = torch.where(u < p_star_cond, 0, 1).to(torch.int32)
        info = TypeSwitchInfo(p_star_cond=p_star_cond, accept_star=info_s.accept_prob,
                              accept_gal=info_g.accept_prob)
        return TypeSwitchState(a=a_new, star=star_new, gal=gal_new), info

    return step


def run_type_switch(gen, kernel, state: TypeSwitchState, n_steps: int):
    """Run the sweep ``n_steps`` times; returns (a_trace [B, n], star_x
    [B, n, Ds], gal_x [B, n, Dg], final state, infos stacked to [B, n])."""
    a_tr, xs_tr, xg_tr, infos = [], [], [], []
    for _ in range(n_steps):
        state, info = kernel(gen, state)
        a_tr.append(state.a)
        xs_tr.append(state.star.x)
        xg_tr.append(state.gal.x)
        infos.append(info)
    stacked = TypeSwitchInfo(*(torch.stack(f, dim=1) for f in zip(*infos)))
    return (torch.stack(a_tr, 1), torch.stack(xs_tr, 1), torch.stack(xg_tr, 1), state,
            stacked)


def sample_source_type_core(gens, logd_s, logd_g, x0_star, x0_gal, prior_star: float = 0.5,
                            n_chains: int = 8, n_steps: int = 400,
                            n_warmup_frac: float = 0.25, n_map_steps: int = 400,
                            step_scale: float = 0.5, n_leapfrog: int = 8):
    """The Carlin-Chib run of N candidates against explicit batched log
    densities: fit the pseudo-priors of each (``x0_star`` [N, Ds], ``x0_gal``
    [N, Dg]), run ``n_chains`` chains of the composite sampler per
    candidate, and return each candidate's posterior P(star) with full
    parameter uncertainty.  ``gens``: one generator per candidate, every
    draw of candidate i from ``gens[i]``.

    ``step_scale`` is the dimensionless HMC step in the Laplace-whitened
    metric (the inverse mass already carries the scales).  Returns a dict of
    per-candidate arrays: ``p_star`` [N] (Rao-Blackwellised: the mean
    conditional probability after burn-in), ``p_star_indicator``,
    ``a_trace`` [N, n_chains, n_steps], the kept samples, the conditional
    means ``x_star_mean`` / ``x_gal_mean`` (each model's draws while its
    chain occupied it; the unmasked mean if a candidate never visited it)
    and ``switch_rate``."""
    n = x0_star.shape[0]
    noise = CandidateStreams(gens)
    pseudo_s, _ = fit_pseudo_prior(logd_s, x0_star, n_map_steps=n_map_steps)
    pseudo_g, _ = fit_pseudo_prior(logd_g, x0_gal, n_map_steps=n_map_steps)
    rows_s, rows_g = pseudo_s.rows(n_chains), pseudo_g.rows(n_chains)
    kern = type_switch_kernel(logd_s, logd_g, rows_s, rows_g, step_size_star=step_scale,
                              step_size_gal=step_scale, n_leapfrog=n_leapfrog,
                              prior_star=prior_star, noise=noise)
    state = type_switch_init(rows_s.sample(None, noise), rows_g.sample(None, noise),
                             logd_s, logd_g)
    u = noise.uniform(None, state.star.logp)
    state = state._replace(a=torch.where(u < prior_star, 0, 1).to(torch.int32))
    a_tr, xs_tr, xg_tr, _, infos = run_type_switch(None, kern, state, n_steps)

    def per_cand(t):
        return t.reshape((n, n_chains) + tuple(t.shape[1:]))

    a_tr, xs_tr, xg_tr = per_cand(a_tr), per_cand(xs_tr), per_cand(xg_tr)
    p_cond = per_cand(infos.p_star_cond)
    burn = int(n_steps * n_warmup_frac)
    a_kept = a_tr[:, :, burn:].to(torch.float32)       # 1 = galaxy model
    xs_kept, xg_kept = xs_tr[:, :, burn:], xg_tr[:, :, burn:]

    def cond_mean(x, w):
        den = torch.sum(w, dim=(1, 2))
        num = torch.sum(x * w[..., None], dim=(1, 2))
        return torch.where(den[:, None] > 0, num / torch.clamp(den, min=1.0)[:, None],
                           torch.mean(x, dim=(1, 2)))

    return {
        "p_star": torch.mean(p_cond[:, :, burn:], dim=(1, 2)),
        "p_star_indicator": 1.0 - torch.mean(a_kept, dim=(1, 2)),
        "a_trace": a_tr,
        "x_star_samples": xs_kept,
        "x_gal_samples": xg_kept,
        "x_star_mean": cond_mean(xs_kept, 1.0 - a_kept),
        "x_gal_mean": cond_mean(xg_kept, a_kept),
        "switch_rate": torch.mean(torch.abs(torch.diff(a_tr, dim=2)).to(torch.float32),
                                  dim=(1, 2)),
    }


def sample_source_type(seed: int, stamps, bands, x0_star, x0_gal, priors=None,
                       n_bands: int = 5, prior_star: float = 0.5, n_chains: int = 8,
                       n_steps: int = 400, n_warmup_frac: float = 0.25,
                       n_map_steps: int = 400, step_scale: float = 0.5, n_leapfrog: int = 8):
    """End-to-end convenience wrapper: the unconditional star and galaxy
    posteriors of ``stamps`` and ``sample_source_type_core`` on each row of
    ``x0_star`` [N, Ds] / ``x0_gal`` [N, Dg] (or one source, [Ds] / [Dg]);
    row i draws from the stream (seed, i) (``utils.rng``).  A single source
    returns its own arrays, without the candidate axis."""
    from celeste_tpu_torch.inference.problems import (
        make_galaxy_logdensity, make_star_logdensity,
    )
    from celeste_tpu_torch.utils.rng import seeded_generator

    logd_s = make_star_logdensity(stamps, bands, priors=priors, n_bands=n_bands)
    logd_g = make_galaxy_logdensity(stamps, bands, priors=priors, n_bands=n_bands)
    single = x0_star.dim() == 1
    xs0, xg0 = (x0_star[None], x0_gal[None]) if single else (x0_star, x0_gal)
    gens = [seeded_generator(xs0.device, seed, i) for i in range(xs0.shape[0])]
    out = sample_source_type_core(gens, logd_s, logd_g, xs0, xg0, prior_star=prior_star,
                                  n_chains=n_chains, n_steps=n_steps,
                                  n_warmup_frac=n_warmup_frac, n_map_steps=n_map_steps,
                                  step_scale=step_scale, n_leapfrog=n_leapfrog)
    return {k: v[0] for k, v in out.items()} if single else out
