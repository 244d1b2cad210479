"""Source parameters and their constrained <-> unconstrained bijections.

Counterpart of ``celeste_tpu/model/params.py``.  Every field may carry
leading batch dimensions; the samplers hold a [B, D] batch of flat vectors.

Flat-vector packing order:
  star:    [du_e, du_n, log_flux_0..B-1]                     D = 2 + B
  galaxy:  [du_e, du_n, log_flux_0..B-1, logit_theta, log_sigma,
            logit_ab, phi]                                   D = 6 + B
(du_e, du_n are east/north arcsec offsets from the scene reference point.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid(x):
    return torch.sigmoid(x)


def logit(p):
    return torch.log(p) - torch.log1p(-p)


class StarParams:
    """Point source: sky position (arcsec offsets) + per-band fluxes
    (nanomaggies)."""

    def __init__(self, u, flux):
        self.u = u
        self.flux = flux

    @property
    def n_bands(self):
        return self.flux.shape[-1]

    def to_vector(self):
        return torch.cat([self.u, torch.log(self.flux)], dim=-1)

    @classmethod
    def from_vector(cls, vec, n_bands):
        return cls(vec[..., :2], torch.exp(vec[..., 2:2 + n_bands]))

    @staticmethod
    def log_det_jacobian(vec, n_bands):
        """log |d(constrained)/d(unconstrained)| of the exp transform."""
        return torch.sum(vec[..., 2:2 + n_bands], dim=-1)


class GalaxyParams:
    """Galaxy: position, fluxes, and the four shape parameters.

    theta_dev in (0, 1) — fraction of flux in the deV profile.
    sigma > 0  — half-light radius of the circular profile, arcsec.
    ab in (0, 1) — minor/major axis ratio.
    phi — position angle, radians (counterclockwise from +x/east).
    """

    def __init__(self, u, flux, theta_dev, sigma, ab, phi):
        self.u = u
        self.flux = flux
        self.theta_dev = theta_dev
        self.sigma = sigma
        self.ab = ab
        self.phi = phi

    @property
    def n_bands(self):
        return self.flux.shape[-1]

    def to_vector(self):
        scalars = torch.stack(
            [logit(self.theta_dev), torch.log(self.sigma), logit(self.ab), self.phi], dim=-1)
        return torch.cat([self.u, torch.log(self.flux), scalars], dim=-1)

    @classmethod
    def from_vector(cls, vec, n_bands):
        b = n_bands
        return cls(
            u=vec[..., :2],
            flux=torch.exp(vec[..., 2:2 + b]),
            theta_dev=torch.sigmoid(vec[..., 2 + b]),
            sigma=torch.exp(vec[..., 3 + b]),
            ab=torch.sigmoid(vec[..., 4 + b]),
            phi=vec[..., 5 + b],
        )

    @staticmethod
    def log_det_jacobian(vec, n_bands):
        b = n_bands
        log_flux_term = torch.sum(vec[..., 2:2 + b], dim=-1)
        lt = vec[..., 2 + b]
        ls = vec[..., 3 + b]
        la = vec[..., 4 + b]

        def sig_ljd(x):  # log d sigmoid/dx
            return -x - 2.0 * F.softplus(-x)

        return log_flux_term + sig_ljd(lt) + ls + sig_ljd(la)


def galaxy_shape_cov_arcsec(theta_unused, sigma, ab, phi):
    """On-sky shape covariance W (arcsec^2) of the elliptical profile,
    W = R(phi) diag(sigma^2, (ab sigma)^2) R(phi)^T, as [..., 2, 2]."""
    c, s = torch.cos(phi), torch.sin(phi)
    maj = sigma**2
    mnr = (ab * sigma) ** 2
    w_xx = c * c * maj + s * s * mnr
    w_yy = s * s * maj + c * c * mnr
    w_xy = c * s * (maj - mnr)
    return torch.stack(
        [torch.stack([w_xx, w_xy], dim=-1), torch.stack([w_xy, w_yy], dim=-1)], dim=-2)
