"""The plain renderer: expected photo-electron counts of a scene of stars
and galaxies in one band, in float64 NumPy with explicit component loops
(Regier et al. 2015, eqs. 1-9; Hogg & Lang 2013), frozen.

Positions are pixel coordinates; pixel (i, j) is centred at x = j, y = i.
A star is the PSF mixture at its position; a galaxy is the theta-mixed
exp/deV profile, its shape covariance taken into pixels by the WCS
Jacobian and convolved with the PSF analytically.
"""

from __future__ import annotations

import math

import numpy as np

from skybench.reference.tables import DEV_AMPS, DEV_VARS, EXP_AMPS, EXP_VARS


def _gauss2d(dx, dy, cov):
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    det = a * c - b * b
    quad = (c * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
    return np.exp(-0.5 * quad) / (2.0 * math.pi * math.sqrt(det))


def galaxy_shape_px(sigma_arcsec, ab, phi, jac):
    """Pixel-space shape covariance J R diag(s^2, (ab s)^2) R^T J^T."""
    c, s = math.cos(phi), math.sin(phi)
    rot = np.array([[c, -s], [s, c]])
    w_sky = rot @ np.diag([sigma_arcsec ** 2, (ab * sigma_arcsec) ** 2]) @ rot.T
    return jac @ w_sky @ jac.T


def source_density(src, shape, psf_w, psf_var, jac):
    """Unit-flux density [H, W] of one source dict (``kind``, ``x_px``,
    ``y_px`` and, for a galaxy, ``theta_dev``, ``sigma_arcsec``, ``ab``,
    ``phi``)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx, dy = xx - src["x_px"], yy - src["y_px"]
    dens = np.zeros((h, w))
    if src["kind"] == "star":
        for wk, vk in zip(psf_w, psf_var):
            dens += wk * _gauss2d(dx, dy, vk * np.eye(2))
        return dens
    w_px = galaxy_shape_px(src["sigma_arcsec"], src["ab"], src["phi"], jac)
    th = src["theta_dev"]
    profile = ([((1.0 - th) * a, v) for a, v in zip(EXP_AMPS, EXP_VARS)]
               + [(th * a, v) for a, v in zip(DEV_AMPS, DEV_VARS)])
    for a_j, v_j in profile:
        for wk, vk in zip(psf_w, psf_var):
            dens += a_j * wk * _gauss2d(dx, dy, v_j * w_px + vk * np.eye(2))
    return dens


def expected_counts(sources, band, shape, sky, iota, psf_w, psf_var, jac):
    """lambda [H, W] of ``sources`` in survey band ``band`` (an index into
    each source's ``flux_nmgy``)."""
    lam = np.full(shape, float(sky))
    for src in sources:
        lam += iota * src["flux_nmgy"][band] * source_density(src, shape, psf_w, psf_var, jac)
    return lam
