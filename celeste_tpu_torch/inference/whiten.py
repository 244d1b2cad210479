"""Dense-metric (whitened-space) sampling (counterpart of
``celeste_tpu/inference/whiten.py``).

HMC and NUTS carry a diagonal inverse mass.  Crowded fields couple fluxes
and positions across overlapping sources, so the diagonal metric leaves the
posterior anisotropic and the step size collapses.  With O(1e3) chains the
ensemble itself estimates the posterior covariance after a short diagonal
warmup, and sampling then runs in the whitened space x = m + L z
(L = chol(cov)), where the posterior is near isotropic and the samplers are
unchanged.  The constant log |det L| is dropped.

The D x D products (D = 44 on config 5) are taken in float64 and rounded
back to float32: TF32, which a card may use for float32 matmuls, keeps about
three decimal digits, and the JAX package computes them at
``Precision.HIGHEST`` for the same reason.

Groups.  ``ensemble_covariance(..., groups=G)`` pools each of G ensembles
stacked set-major (the field pipeline's fit groups) into its own moments,
[G, D] and [G, D, D], and ``whiten_logdensity`` given such moments whitens
each group's rows with its own factor, the products batched over groups in
float64 all the same.  One ensemble is the case G = 1.
"""

from __future__ import annotations

import torch

from celeste_tpu_torch.inference.hmc import hmc_warmup_finish, hmc_warmup_init, hmc_warmup_window
from celeste_tpu_torch.inference.nuts import nuts_kernel
from celeste_tpu_torch.inference.runner import run_chains_ensemble
from celeste_tpu_torch.utils.profiling import span


def _mm64(a, b):
    """float32 a @ b, computed in float64 (never TF32)."""
    return torch.matmul(a.double(), b.double()).float()


def ensemble_covariance(xs, ridge: float = 1e-6, groups: int | None = None):
    """Pooled covariance of ensemble states ``xs`` [n_chains, D] or
    [n_chains, n_steps, D].  Returns (mean [D], cov [D, D]) with a relative
    ridge on the diagonal, so that the Cholesky factor always exists.  With
    ``groups`` = G the chains are G ensembles stacked set-major, each pooled
    alone: (mean [G, D], cov [G, D, D])."""
    flat = xs.reshape(groups or 1, -1, xs.shape[-1]).to(torch.float32)
    m = torch.mean(flat, dim=1)
    c = flat - m[:, None, :]
    cov = _mm64(c.mT, c) / (flat.shape[1] - 1)
    d = torch.amax(torch.diagonal(cov, dim1=1, dim2=2), dim=1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    cov = cov + (ridge * torch.clamp(d, min=1e-20))[:, None, None] * eye
    return (m, cov) if groups is not None else (m[0], cov[0])


def whiten_logdensity(logdensity_fn, mean, cov):
    """Wrap a batched ``logdensity_fn`` for the whitened space x = mean + L z.

    Returns ``(logd_z, to_x, to_z)``: the z-space log density ``[B, D] -> [B]``
    and the affine maps between the spaces (any leading batch axes).  With
    per-group moments (mean [G, D], cov [G, D, D]) the rows, and any axes
    after them, are G groups stacked set-major, each mapped by its own.
    """
    mean = torch.as_tensor(mean, dtype=torch.float32)
    chol = torch.linalg.cholesky(torch.as_tensor(cov, dtype=torch.float64, device=mean.device))
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    chol_t, chol_inv_t = chol.mT.contiguous(), chol_inv.mT.contiguous()
    d = mean.shape[-1]
    m = mean.reshape(-1, 1, d)          # [G, 1, D]; one ensemble is G = 1

    def by_group(fn, v):
        return fn(v.reshape(m.shape[0], -1, d)).reshape(v.shape)

    def to_x(z):
        with span("whiten.to_x"):
            return by_group(lambda zg: m + _mm64(zg, chol_t), z)

    def to_z(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        return by_group(lambda xg: _mm64(xg - m, chol_inv_t), x)

    return (lambda z: logdensity_fn(to_x(z))), to_x, to_z


def dense_metric_from_probe(gen, logdensity_fn, states, step_size, inv_mass, probe_steps: int,
                            n_zwarm: int, n_leapfrog: int, max_depth: int = 6):
    """The dense-metric preparation after a diagonal warmup: a NUTS probe of
    ``probe_steps`` steps with the diagonal metric from ``states`` (an
    ``HMCState``), the pooled ensemble covariance of its draws (ridge 1e-4),
    the whitened log density, and an HMC warmup of ``n_zwarm`` steps that
    re-adapts the step size in z-space.  Returns a dict: ``logd_z``,
    ``to_x``, ``to_z``, the z-space ``states_z``, ``step_z`` (the median of
    the chains' adapted step sizes) and ``moments`` (mean, cov)."""
    probe = nuts_kernel(logdensity_fn, step_size=step_size, inv_mass=inv_mass,
                        max_depth=max_depth)
    s_probe, _, _ = run_chains_ensemble(gen, probe, states, n_steps=probe_steps)
    m_hat, cov_hat = ensemble_covariance(s_probe, ridge=1e-4)
    logd_z, to_x, to_z = whiten_logdensity(logdensity_fn, m_hat, cov_hat)
    carry = hmc_warmup_init(to_z(states.x), logd_z, init_step_size=0.3)
    carry = hmc_warmup_window(gen, logd_z, carry, n_zwarm, n_warmup=n_zwarm,
                              n_leapfrog=n_leapfrog)
    states_z, ss_z, _ = hmc_warmup_finish(carry)
    return {"logd_z": logd_z, "to_x": to_x, "to_z": to_z, "states_z": states_z,
            "step_z": float(torch.quantile(ss_z, 0.5)), "moments": (m_hat, cov_hat)}


def whitened_chees_run(gen, logdensity_fn, probe_samples, states_x, n_warmup: int = 100,
                       n_steps: int = 400, init_step_size: float = 0.3,
                       max_leapfrog: int = 64, ridge: float = 1e-4):
    """The dense-metric ChEES recipe in one call: pool the metric from
    ``probe_samples`` [B, n, D], whiten, adapt (eps, T) from ``states_x``
    [B, D], and sample.  Returns (samples_x [B, n_steps, D], infos, aux with
    eps, traj, to_x, to_z, logd_z and the final z-space state)."""
    from celeste_tpu_torch.inference.chees import chees_warmup, run_chees_ensemble

    m_hat, cov_hat = ensemble_covariance(probe_samples, ridge=ridge)
    logd_z, to_x, to_z = whiten_logdensity(logdensity_fn, m_hat, cov_hat)
    st, eps, traj = chees_warmup(gen, logd_z, to_z(states_x), n_warmup=n_warmup,
                                 init_step_size=init_step_size, max_leapfrog=max_leapfrog)
    eps, traj = float(eps), float(traj)
    samples_z, st, infos = run_chees_ensemble(gen, logd_z, st, n_steps=n_steps, step_size=eps,
                                              trajectory_length=traj,
                                              max_leapfrog=max_leapfrog)
    aux = {"eps": eps, "traj": traj, "to_x": to_x, "to_z": to_z, "logd_z": logd_z,
           "final_state": st}
    return to_x(samples_z), infos, aux
