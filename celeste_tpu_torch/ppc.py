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
  deviance;
- ``catalog_vs_truth``  — per-source position and flux pulls of a catalog
  against a truth record.

The scoring is host NumPy, copied from the JAX package, and the draws are
picked by the same ``np.random.default_rng(seed).choice``, so both packages
score the same draws.
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


def catalog_vs_truth(catalog, truth_sources, wcs, bands=None):
    """photoObj-style comparison: per source, the flux and position pulls
    ((posterior mean - truth) / posterior sd) against a truth record (a
    list of ``data.synthetic``-style source dicts, or any dicts with 'u'
    [ra, dec] and 'flux' [B]).

    Matching is the symmetric closest-pair cross-match
    (``celeste_tpu_torch.catalog.match_catalogs``) with no separation cut,
    so a spuriously-far catalog row cannot steal a truth source from a
    closer row.  For aggregate metrics (completeness, purity, z-score RMS)
    use ``catalog.catalog_accuracy``; this function keeps the per-source
    pull rows, aligned to catalog order.

    ``bands`` maps the catalog's flux slots to truth flux indices (e.g.
    ``[2]`` for an r-band-only model against ugriz truth); identity when
    omitted.  Returns a list of dicts with du_pull [2], flux_pull [B] and
    the matched truth index.
    """
    from celeste_tpu_torch.catalog import match_catalogs

    truths = [{"du": np.asarray(wcs.equa2duas(t["u"]), np.float64),
               "flux": np.asarray(t["flux"], np.float64)} for t in truth_sources]
    pairs, _, _ = match_catalogs(
        [np.asarray(e.du_mean, np.float64) for e in catalog],
        [t["du"] for t in truths], max_sep_arcsec=np.inf)
    by_cat = {i: (j, d) for i, j, d in pairs}
    rows = []
    for idx, entry in enumerate(catalog):
        if idx not in by_cat:
            rows.append({"match": None})
            continue
        best, best_d = by_cat[idx]
        t = truths[best]
        slots = (np.asarray(bands, int) if bands is not None
                 else np.arange(len(entry.flux_mean)))
        flux_t = t["flux"][slots]
        du_pull = (np.asarray(entry.du_mean) - t["du"]) / np.maximum(
            np.asarray(entry.du_std), 1e-9)
        flux_pull = (np.asarray(entry.flux_mean) - flux_t) / np.maximum(
            np.asarray(entry.flux_std), 1e-9)
        rows.append({"match": best, "dist_arcsec": best_d,
                     "du_pull": du_pull, "flux_pull": flux_pull,
                     "kind": entry.kind})
    return rows
