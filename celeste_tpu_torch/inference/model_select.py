"""Star-vs-galaxy source classification by Laplace evidence (counterpart of
``celeste_tpu/inference/model_select.py``).

Fit both models, estimate each marginal likelihood by the Laplace
approximation at the MAP, log Z ~= logp(x*) + D/2 log 2pi - 1/2 log det(-H),
and report the posterior type probability.

The Hessian comes from central differences of the batched gradient, not
from a second derivative: on the card the log density runs through the
stamp kernel K1, whose backward (K1-bwd) has no derivative of its own.
All 2D perturbed points of all N rows, and the N points themselves, go
through one ``value_and_grad`` call of a [N (2D + 1), D] batch (one K1-fwd
and one K1-bwd launch on the card); the CPU takes the same route, so the
tests exercise the code the card runs.  The step is ``FD_STEP`` in
unconstrained coordinates (positions in arcsec, log fluxes, the shape's
logits and logs): wide enough that the float32 gradient's rounding stays
small against the differences, narrow against the posterior's widths.
On the stamp pipeline's star (D = 3) and galaxy (D = 7) conditional MAPs,
1/2 log det(-H) at steps from 1e-3 to 1e-2 lies within 0.01 nats of
``jax.hessian``'s (tests/test_torch_model_select.py).
"""

from __future__ import annotations

import math

import torch

from celeste_tpu_torch.inference.hmc import value_and_grad
from celeste_tpu_torch.inference.map_fit import map_fit

FD_STEP = 5e-3
LOG_2PI = math.log(2.0 * math.pi)


def hessian_fd(logdensity_fn, x, step: float = FD_STEP):
    """(logp [N], symmetrised Hessian [N, D, D]) of a batched log density at
    ``x`` [N, D]: central differences of the gradient along each axis, every
    point in one batch [N, 2D + 1, D] whose rows stay grouped by the row of
    ``x`` they perturb (row n's points are rows n (2D + 1) .. (n + 1) (2D +
    1) - 1), as the pipeline's conditional log densities expect."""
    n, d = x.shape
    eye = step * torch.eye(d, dtype=x.dtype, device=x.device)
    pts = torch.cat([x[:, None, :], x[:, None, :] + eye, x[:, None, :] - eye], dim=1)
    logp, grad = value_and_grad(logdensity_fn, pts.reshape(n * (2 * d + 1), d))
    grad = grad.reshape(n, 2 * d + 1, d)
    # column j: d grad / d x_j
    h = ((grad[:, 1:d + 1] - grad[:, d + 1:]) / (2.0 * step)).transpose(1, 2)
    return logp.reshape(n, 2 * d + 1)[:, 0], 0.5 * (h + h.transpose(1, 2))


def laplace_from_hessian(logp, h):
    """Laplace log evidence [N] from the log density at the modes [N] and
    the Hessians [N, D, D] there.  -H must be positive definite at a mode:
    it is regularised by 1e-6 on the diagonal, and where its determinant is
    not positive (not a maximum) the evidence is -inf."""
    d = h.shape[-1]
    neg_h = (-h).double() + 1e-6 * torch.eye(d, dtype=torch.float64, device=h.device)
    sign, logdet = torch.linalg.slogdet(neg_h)
    logdet = torch.where(sign > 0, logdet, torch.full_like(logdet, math.inf))
    return (logp.double() + 0.5 * d * LOG_2PI - 0.5 * logdet).to(logp.dtype)


def laplace_evidence(logdensity_fn, x_map, step: float = FD_STEP):
    """log Z [N] by the Laplace approximation at the (approximate) modes
    ``x_map`` [N, D] of a batched log density."""
    logp, h = hessian_fd(logdensity_fn, x_map, step)
    return laplace_from_hessian(logp, h)


def classify_source(stamps, bands, x0_star, x0_galaxy, priors=None, n_bands: int = 5,
                    prior_star: float = 0.5, n_map_steps: int = 400):
    """Posterior P(star | data) of a source, or of each row of a batch of
    starts of it (``x0_star`` [Ds] or [N, Ds], ``x0_galaxy`` [Dg] or [N,
    Dg]), from the unconditional star and galaxy posteriors of
    ``inference.problems``.  Returns a dict with p_star, the two log
    evidences and both MAP vectors, shaped as the inputs."""
    from celeste_tpu_torch.inference.problems import (
        make_galaxy_logdensity,
        make_star_logdensity,
    )

    logd_s = make_star_logdensity(stamps, bands, priors=priors, n_bands=n_bands)
    logd_g = make_galaxy_logdensity(stamps, bands, priors=priors, n_bands=n_bands)
    single = x0_star.dim() == 1
    xs0, xg0 = (x0_star[None], x0_galaxy[None]) if single else (x0_star, x0_galaxy)

    xs, _ = map_fit(logd_s, xs0, n_steps=n_map_steps)
    xg, _ = map_fit(logd_g, xg0, n_steps=n_map_steps)
    log_z_s = laplace_evidence(logd_s, xs)
    log_z_g = laplace_evidence(logd_g, xg)

    log_odds = (log_z_s + math.log(prior_star)) - (log_z_g + math.log1p(-prior_star))
    out = {"p_star": torch.sigmoid(log_odds), "log_evidence_star": log_z_s,
           "log_evidence_galaxy": log_z_g, "x_map_star": xs, "x_map_galaxy": xg}
    return {k: v[0] for k, v in out.items()} if single else out
