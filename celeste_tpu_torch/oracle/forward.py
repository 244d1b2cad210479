"""Oracle forward model: NumPy, explicit loops, written independently from
the papers (Regier et al. 2015 "Celeste" eqs. 1-9; Hogg & Lang 2013).

Interfaces take plain dicts/arrays so the oracle shares no code with the
tensor path beyond the generated profile tables.  Copied from
``celeste_tpu/oracle/forward.py``: ``data/synthetic.py`` draws its counts
through it, so both packages simulate identical data from one seed.
"""

from __future__ import annotations

import math

import numpy as np

from celeste_tpu_torch.model._profile_tables import DEV_AMPS, DEV_VARS, EXP_AMPS, EXP_VARS

ARCSEC_PER_DEG = 3600.0


def _gauss2d(dx, dy, cov):
    """Bivariate Gaussian density, explicit 2x2 math; ``dx``/``dy`` may be
    arrays (the oracle vectorizes over pixels like the 2014-era reference's
    NumPy code, keeping only the component loops in Python — this also makes
    it an honest ESS/sec denominator for BASELINE.md)."""
    a, b, c = cov[0, 0], cov[0, 1], cov[1, 1]
    det = a * c - b * b
    inv_a, inv_b, inv_c = c / det, -b / det, a / det
    quad = inv_a * dx * dx + 2 * inv_b * dx * dy + inv_c * dy * dy
    return np.exp(-0.5 * quad) / (2 * math.pi * math.sqrt(det))


def equa2pixel(u, wcs):
    """wcs = dict(A=[2,2] px/deg, u0=[2] deg, p0=[2] px)."""
    return np.asarray(wcs["p0"]) + np.asarray(wcs["A"]) @ (np.asarray(u) - np.asarray(wcs["u0"]))


def oracle_star_lambda(u, flux, stamp):
    """Expected counts [H,W] for one star.

    stamp: dict with keys 'shape' (H,W), 'sky' ([H,W] or scalar), 'iota',
    'wcs', 'psf_w' [K], 'psf_mu' [K,2], 'psf_cov' [K,2,2].
    """
    h, w = stamp["shape"]
    p = equa2pixel(u, stamp["wcs"])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dens = np.zeros((h, w))
    for k in range(len(stamp["psf_w"])):
        dx = xx - (p[0] + stamp["psf_mu"][k][0])
        dy = yy - (p[1] + stamp["psf_mu"][k][1])
        dens += stamp["psf_w"][k] * _gauss2d(dx, dy, np.asarray(stamp["psf_cov"][k]))
    return np.asarray(stamp["sky"]) + stamp["iota"] * flux * dens


def _rot(phi):
    c, s = math.cos(phi), math.sin(phi)
    return np.array([[c, -s], [s, c]])


def oracle_galaxy_lambda(u, flux, theta_dev, sigma, ab, phi, stamp):
    """Expected counts [H,W] for one galaxy: theta-mixed exp/deV tables,
    shape-scaled, analytically convolved with the PSF MoG."""
    h, w = stamp["shape"]
    p = equa2pixel(u, stamp["wcs"])
    # d(pixel)/d(true east-north arcsec): galaxy shape lives in true angular
    # units, so the ra axis of the px/deg WCS Jacobian must be de-compressed
    # by cos(dec) before converting deg -> arcsec.
    cosd = math.cos(math.radians(float(np.asarray(stamp["wcs"]["u0"])[1])))
    j = np.asarray(stamp["wcs"]["A"]) @ np.diag([1.0 / (ARCSEC_PER_DEG * cosd),
                                                 1.0 / ARCSEC_PER_DEG])
    r_mat = _rot(phi)
    w_sky = r_mat @ np.diag([sigma**2, (ab * sigma) ** 2]) @ r_mat.T
    w_px = j @ w_sky @ j.T

    comps = []  # (weight, cov) pairs of profile (pre-PSF)
    for a_j, v_j in zip(EXP_AMPS, EXP_VARS):
        comps.append(((1.0 - theta_dev) * a_j, v_j * w_px))
    for a_j, v_j in zip(DEV_AMPS, DEV_VARS):
        comps.append((theta_dev * a_j, v_j * w_px))

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dens = np.zeros((h, w))
    for (a_j, cov_j) in comps:
        for k in range(len(stamp["psf_w"])):
            cov = cov_j + np.asarray(stamp["psf_cov"][k])
            dx = xx - (p[0] + stamp["psf_mu"][k][0])
            dy = yy - (p[1] + stamp["psf_mu"][k][1])
            dens += a_j * stamp["psf_w"][k] * _gauss2d(dx, dy, cov)
    return np.asarray(stamp["sky"]) + stamp["iota"] * flux * dens


def oracle_scene_lambda(sources, stamp):
    """Sum of per-source lambdas (minus double-counted sky)."""
    h, w = stamp["shape"]
    lam = np.zeros((h, w)) + np.asarray(stamp["sky"])
    for src in sources:
        if src["type"] == "star":
            part = oracle_star_lambda(src["u"], src["flux"], stamp)
        else:
            part = oracle_galaxy_lambda(
                src["u"], src["flux"], src["theta_dev"], src["sigma"], src["ab"], src["phi"], stamp
            )
        lam += part - np.asarray(stamp["sky"])
    return lam


def oracle_poisson_loglik(lam, counts, normalized=False):
    lam = np.maximum(lam, 1e-10)
    out = np.sum(counts * np.log(lam) - lam)
    if normalized:
        out -= np.sum([math.lgamma(c + 1.0) for c in np.ravel(counts)])
    return out
