"""Priors over source parameters, evaluated in constrained space.

Counterpart of ``celeste_tpu/model/priors.py``: a flat position prior with a
Gaussian roll-off, a log-normal reference-band flux prior with Gaussian
colors, and the galaxy shape prior.  The sampler-side log |det J| is added
by the posterior factory (``inference/problems.py``).

The empirical color GMM (``color_gmm``) belongs to config 2 and is not
ported yet: a ``FluxPrior`` given one raises rather than ignoring it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

REF_BAND = 2  # r band


def _normal_logpdf(x, mean, std):
    """``mean``/``std`` are Python floats or tensors."""
    z = (x - mean) / std
    log_std = torch.log(std) if torch.is_tensor(std) else math.log(std)
    return -0.5 * z * z - log_std - 0.9189385332046727


def _beta_logpdf(x, a, b):
    """Normalized Beta(a, b) log-density (a, b are Python floats)."""
    log_norm = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) + log_norm


@dataclass(frozen=True)
class FluxPrior:
    """Reference-band log-normal + Gaussian color prior."""

    log_ref_mean: float = 3.0       # log nanomaggies (~20 nmgy)
    log_ref_std: float = 3.0        # broad
    color_mean: tuple = (0.0, 0.0, 0.0, 0.0)
    color_std: tuple = (1.5, 1.5, 1.5, 1.5)
    ref_band: int = REF_BAND
    color_gmm: Optional[object] = None

    def __post_init__(self):
        if self.color_gmm is not None:
            raise NotImplementedError(
                "the color GMM prior (config 2) is not yet ported to celeste_tpu_torch")

    def logpdf(self, log_flux):
        """``log_flux`` [..., B] natural-log fluxes -> the constrained-space
        density over the flux vector, including the -sum(log flux) measure
        term of the log -> flux change of variables."""
        b = log_flux.shape[-1]
        # clamp the reference slot so 2-band problems stay in range
        ref = min(self.ref_band, b - 1)
        lp = _normal_logpdf(log_flux[..., ref], self.log_ref_mean, self.log_ref_std)
        if b > 1:
            colors = log_flux[..., :-1] - log_flux[..., 1:]
            kw = dict(dtype=torch.float32, device=log_flux.device)
            mean = torch.as_tensor(self.color_mean[: b - 1], **kw)
            std = torch.as_tensor(self.color_std[: b - 1], **kw)
            lp = lp + torch.sum(_normal_logpdf(colors, mean, std), dim=-1)
        return lp - torch.sum(log_flux, dim=-1)


@dataclass(frozen=True)
class PositionPrior:
    """Flat within a box of half-width ``halfwidth_arcsec`` around the scene
    reference; a Gaussian roll-off outside keeps the posterior proper."""

    halfwidth_arcsec: float = 60.0
    rolloff: float = 1.0

    def logpdf(self, du):
        excess = torch.clamp(torch.abs(du) - self.halfwidth_arcsec, min=0.0)
        return -0.5 * torch.sum((excess / self.rolloff) ** 2, dim=-1)


@dataclass(frozen=True)
class GalaxyShapePrior:
    """theta_dev ~ Beta(a, b); log sigma ~ N; ab ~ Beta; phi ~ flat."""

    theta_a: float = 1.0
    theta_b: float = 1.0
    log_sigma_mean: float = 0.3     # ~1.35 arcsec
    log_sigma_std: float = 1.0
    ab_a: float = 1.0
    ab_b: float = 1.0

    def logpdf(self, theta_dev, sigma, ab, phi):
        """Constrained-space density over (theta_dev, sigma, ab, phi)."""
        lp = _beta_logpdf(theta_dev, self.theta_a, self.theta_b)
        lp = lp + _normal_logpdf(torch.log(sigma), self.log_sigma_mean,
                                 self.log_sigma_std) - torch.log(sigma)
        lp = lp + _beta_logpdf(ab, self.ab_a, self.ab_b)
        # phi uniform over the pi-periodic angle
        return lp - math.log(math.pi)


@dataclass(frozen=True)
class SourcePriors:
    flux: FluxPrior = field(default_factory=FluxPrior)
    position: PositionPrior = field(default_factory=PositionPrior)
    shape: GalaxyShapePrior = field(default_factory=GalaxyShapePrior)

    def star_logpdf(self, params):
        return self.flux.logpdf(torch.log(params.flux)) + self.position.logpdf(params.u)

    def galaxy_logpdf(self, params):
        return (
            self.flux.logpdf(torch.log(params.flux))
            + self.position.logpdf(params.u)
            + self.shape.logpdf(params.theta_dev, params.sigma, params.ab, params.phi)
        )
