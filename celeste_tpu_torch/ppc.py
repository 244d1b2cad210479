"""Posterior-predictive checking (counterpart of ``celeste_tpu/ppc.py``).

Given posterior draws of a scene's joint unconstrained vector, simulate
replicated counts and score the observed stamp against the replicate
distribution:

- ``ppc_lambda_draws``  — expected images of a thinned set of draws,
  rendered by the stamp render kernel (``kernels.mog_field.mog_field_render``,
  K7 on the card);
- ``ppc_replicates``    — Poisson replicated counts per draw;
- ``ppc_pixel_zscores`` — observed against predictive mean and sd per pixel;
- ``ppc_chi2_pvalue``   — the posterior-predictive p-value of the Poisson
  deviance.

The scoring is host NumPy, copied from the JAX package, and the draws are
picked by the same ``np.random.default_rng(seed).choice``, so both packages
score the same draws.  The JAX package's ``catalog_vs_truth`` needs the
catalogue cross-match (``catalog.py``) and is ported with the pipelines.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.kernels.mog_field import mog_field_render, stamp_pixel_data
from celeste_tpu_torch.parallel.crowded import CrowdedScene, scene_field_planes


def ppc_lambda_draws(scene: CrowdedScene, samples, stamp, band, n_draws: int = 32,
                     seed: int = 0):
    """Thin posterior draws and render their expected images.

    ``samples``: [n_chains, n_steps, D] (or [N, D]) joint unconstrained
    vectors (NumPy).  The planes of every source of ``scene``, concatenated
    along the component axis, go through one render call on the stamp's
    device.  Returns lam [n_draws, H, W] as NumPy.
    """
    flat = np.asarray(samples).reshape(-1, np.asarray(samples).shape[-1])
    rng = np.random.default_rng(seed)
    idx = rng.choice(flat.shape[0], size=min(n_draws, flat.shape[0]), replace=False)
    vecs = torch.as_tensor(flat[idx], dtype=torch.float32, device=stamp.device)
    h, w = stamp.counts.shape
    with torch.no_grad():
        planes = scene_field_planes(scene, vecs, stamp, band)
        lam = mog_field_render(*planes, stamp_pixel_data(stamp))
    return lam[:, :h * w].reshape(-1, h, w).cpu().numpy()


def ppc_replicates(lam_draws, seed: int = 0):
    """Poisson replicated counts, one per lambda draw."""
    rng = np.random.default_rng(seed)
    return rng.poisson(np.maximum(np.asarray(lam_draws, np.float64), 0.0))


def ppc_pixel_zscores(lam_draws, counts):
    """(observed - predictive mean) / predictive sd per pixel, where the
    predictive variance folds Poisson noise into the lambda spread:
    Var[y_rep] = E[lam] + Var[lam]."""
    lam = np.asarray(lam_draws, np.float64)
    mu = lam.mean(axis=0)
    var = mu + lam.var(axis=0)
    return (np.asarray(counts, np.float64) - mu) / np.sqrt(np.maximum(var, 1e-9))


def _poisson_deviance(counts, lam):
    counts = np.asarray(counts, np.float64)
    lam = np.maximum(np.asarray(lam, np.float64), 1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(counts > 0, counts * np.log(counts / lam), 0.0)
    return 2.0 * np.sum(term - (counts - lam))


def ppc_chi2_pvalue(lam_draws, counts, mask=None, seed: int = 0):
    """Posterior-predictive p-value on the Poisson deviance: for each draw,
    compare the observed deviance against a replicate's (same lambda), and
    report the fraction of draws where the replicate exceeds the observed.
    A calibrated model lands well inside (0, 1); p near 0 means the model
    misses structure, near 1 that it overfits the noise."""
    lam = np.asarray(lam_draws, np.float64)
    counts = np.asarray(counts, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool)
        lam = np.where(m[None], lam, 1e-9)
        counts = np.where(m, counts, 0.0)
    reps = ppc_replicates(lam, seed=seed)
    d_obs = np.array([_poisson_deviance(counts, l) for l in lam])
    d_rep = np.array([_poisson_deviance(r, l) for r, l in zip(reps, lam)])
    return float(np.mean(d_rep > d_obs)), d_obs, d_rep
