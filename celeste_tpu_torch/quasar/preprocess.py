"""Spectro preprocessing (a NumPy copy of ``celeste_tpu/quasar/preprocess.py``;
the reference's BOSS download / clean / resample-to-rest-frame / split
scripts).

The pipeline operates on any (lam_obs, flux, ivar, z) arrays: synthetic in
tests, real BOSS arrays when dropped in.  Steps mirror the reference
pipeline: de-redshift to rest frame, resample onto a common log-spaced grid
(ivar-weighted, flux-conserving in the mean), mask bad pixels, and split
train/validation deterministically.
"""

from __future__ import annotations

import numpy as np


def resample_to_rest(lam_obs, flux, ivar, z, lam_grid):
    """De-redshift one spectrum and resample to ``lam_grid`` (rest-frame).

    ivar-weighted binning: each output bin averages the input samples that
    land in it, weighted by inverse variance; empty bins get ivar 0.
    Returns (flux_grid, ivar_grid).
    """
    lam_rest = np.asarray(lam_obs, np.float64) / (1.0 + z)
    flux = np.asarray(flux, np.float64)
    ivar = np.asarray(ivar, np.float64)
    good = ivar > 0
    lam_rest, flux, ivar = lam_rest[good], flux[good], ivar[good]

    edges = np.empty(len(lam_grid) + 1)
    edges[1:-1] = 0.5 * (lam_grid[1:] + lam_grid[:-1])
    edges[0] = lam_grid[0] - (edges[1] - lam_grid[0])
    edges[-1] = lam_grid[-1] + (lam_grid[-1] - edges[-2])
    idx = np.digitize(lam_rest, edges) - 1
    ok = (idx >= 0) & (idx < len(lam_grid))
    idx, f, w = idx[ok], flux[ok], ivar[ok]

    wsum = np.bincount(idx, weights=w, minlength=len(lam_grid))
    fsum = np.bincount(idx, weights=w * f, minlength=len(lam_grid))
    with np.errstate(invalid="ignore", divide="ignore"):
        flux_grid = np.where(wsum > 0, fsum / np.maximum(wsum, 1e-300), 0.0)
    return flux_grid, wsum


def build_training_matrix(spectra, lam_grid):
    """Stack resampled spectra: ``spectra`` is a list of dicts with keys
    lam_obs, flux, ivar, z.  Returns (flux [N, L], ivar [N, L])."""
    fs, ws = [], []
    for s in spectra:
        f, w = resample_to_rest(s["lam_obs"], s["flux"], s["ivar"], s["z"], lam_grid)
        fs.append(f)
        ws.append(w)
    return np.stack(fs), np.stack(ws)


def train_test_split(n: int, test_frac: float = 0.2, seed: int = 0):
    """Deterministic index split (the reference's train/test protocol)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(round(n * test_frac))
    return np.sort(perm[n_test:]), np.sort(perm[:n_test])


def normalize_spectra(flux, ivar, lam_grid, window=(200.0, 280.0)):
    """Scale each spectrum to unit mean flux in a rest-frame window
    (removes the luminosity degree of freedom before basis fitting, as the
    reference does; the scale returns as the per-target m parameter)."""
    lam_grid = np.asarray(lam_grid)
    sel = (lam_grid >= window[0]) & (lam_grid <= window[1])
    scale = np.array([
        np.average(f[sel], weights=np.maximum(w[sel], 1e-12)) if np.any(w[sel] > 0)
        else max(f.mean(), 1e-12)
        for f, w in zip(flux, ivar)
    ])
    scale = np.maximum(scale, 1e-12)
    return flux / scale[:, None], ivar * scale[:, None] ** 2, scale
