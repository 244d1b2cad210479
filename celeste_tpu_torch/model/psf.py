"""PSF models: per-band point-spread functions as small mixtures of 2-D
Gaussians in pixel coordinates, zero-centered.

Counterpart of ``celeste_tpu/model/psf.py``.  ``fit_psf_mog`` is the
offline NumPy EM fit, copied as it is; only its output lands on a device.
"""

from __future__ import annotations

import numpy as np

from celeste_tpu_torch.mog import MoG2D, isotropic

SDSS_PIXEL_SCALE_ARCSEC = 0.396


def sdss_like_psf(fwhm_arcsec: float = 1.3, pixel_scale: float = SDSS_PIXEL_SCALE_ARCSEC,
                  n_comp: int = 3, device="cpu") -> MoG2D:
    """An SDSS-like 3-component PSF: a tight core, a mid halo and a broad
    wing, matching a ~1.3" FWHM r-band PSF.  Unit flux, zero-centered,
    pixel space."""
    sigma_core_px = fwhm_arcsec / 2.355 / pixel_scale
    if n_comp == 1:
        w = [1.0]
        var = [sigma_core_px**2]
    elif n_comp == 2:
        w = [0.9, 0.1]
        var = [sigma_core_px**2, (2.0 * sigma_core_px) ** 2]
    else:
        w = [0.8, 0.15, 0.05]
        var = [sigma_core_px**2, (1.9 * sigma_core_px) ** 2, (3.8 * sigma_core_px) ** 2]
    mu = np.zeros((len(w), 2), np.float32)
    return isotropic(np.asarray(w, np.float32), mu, np.asarray(var, np.float32), device)


def fit_psf_mog(psf_image: np.ndarray, n_comp: int = 3, n_iter: int = 200,
                device="cpu") -> MoG2D:
    """Fit an isotropic n_comp MoG to a centered, normalized PSF image by EM
    (offline, NumPy).  ``psf_image`` is [H, W], centered at
    ((H-1)/2, (W-1)/2)."""
    img = np.asarray(psf_image, np.float64)
    img = np.clip(img, 0.0, None)
    img = img / img.sum()
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx, dy = (xx - cx).ravel(), (yy - cy).ravel()
    r2 = dx * dx + dy * dy
    wts = img.ravel()

    # init: geometric ladder of widths around the flux-weighted RMS radius
    rms = np.sqrt(np.sum(wts * r2) / 2.0)
    var = (rms**2) * np.geomspace(0.25, 4.0, n_comp)
    pi = np.full(n_comp, 1.0 / n_comp)

    for _ in range(n_iter):
        # E-step: responsibilities under isotropic Gaussians
        log_comp = (-0.5 * r2[:, None] / var[None, :]
                    - np.log(2 * np.pi * var[None, :]) + np.log(pi[None, :]))
        log_comp -= log_comp.max(axis=1, keepdims=True)
        resp = np.exp(log_comp)
        resp /= resp.sum(axis=1, keepdims=True)
        # M-step: flux-weighted updates
        nk = np.sum(wts[:, None] * resp, axis=0)
        var_new = np.sum(wts[:, None] * resp * r2[:, None], axis=0) / (2.0 * nk)
        pi, var = nk / nk.sum(), np.maximum(var_new, 1e-4)

    order = np.argsort(var)
    mu = np.zeros((n_comp, 2), np.float32)
    return isotropic(pi[order].astype(np.float32), mu, var[order].astype(np.float32),
                     device)
