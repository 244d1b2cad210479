"""Synthetic SDSS-like stamp generator: scenes with known ground truth.

Counterpart of ``celeste_tpu/data/synthetic.py``.  Counts are drawn from
``np.random.default_rng(seed)`` through the NumPy oracle, exactly as the
JAX package draws them, so one seed gives bitwise identical counts in both
packages.  Defaults are typical SDSS r-band numbers: 0.396"/px, sky ~150
photo-electrons/px, iota ~800 per nanomaggie, PSF FWHM ~1.3".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from celeste_tpu_torch.model.psf import sdss_like_psf
from celeste_tpu_torch.model.stamp import HostWcs, Stamp
from celeste_tpu_torch.mog import MoG2D
from celeste_tpu_torch.oracle.forward import oracle_scene_lambda

BANDS = ("u", "g", "r", "i", "z")


@dataclass
class SyntheticScene:
    """Ground truth + per-band observation containers."""

    sources: List[dict]
    stamps: List[Stamp]          # one per band, tensors on one device
    oracle_stamps: List[dict]    # plain-dict mirrors for the NumPy oracle
    wcs: HostWcs                 # fp64 host WCS (abs ra/dec <-> px/offsets)
    bands: tuple = BANDS


def _psf_to_numpy(psf: MoG2D):
    return (psf.w.cpu().numpy(), psf.mu.cpu().numpy(), psf.cov.cpu().numpy())


def make_synthetic_stamp(
    sources,
    shape=(25, 25),
    bands=(2,),                      # indices into BANDS; default r only
    sky=150.0,
    iota=800.0,
    fwhm_arcsec=1.3,
    pixel_scale=0.396,
    seed=0,
    band_flux_key="flux",
    device="cpu",
):
    """Render ground-truth sources through the ORACLE forward model and draw
    Poisson counts.  Sources are oracle-style dicts whose 'flux' entry is a
    per-band array (len == len(BANDS)).  Returns a SyntheticScene whose
    stamps live on ``device``."""
    rng = np.random.default_rng(seed)
    h, w = shape
    wcs = HostWcs(pixel_scale_arcsec=pixel_scale, u_ref=(30.0, 10.0),
                  p_ref=((w - 1) / 2.0, (h - 1) / 2.0))
    # the oracle works on absolute degrees: px/deg Jacobian
    A_deg = wcs.A_as @ np.diag([3600.0 * wcs.cosd, 3600.0])
    wcs_np = {"A": A_deg, "u0": wcs.u_ref, "p0": wcs.p_ref}
    dev_A, dev_p0 = wcs.device_affine(device)
    kw = dict(dtype=torch.float32, device=device)

    stamps, oracle_stamps = [], []
    for b in bands:
        psf = sdss_like_psf(fwhm_arcsec=fwhm_arcsec, pixel_scale=pixel_scale, device=device)
        psf_w, psf_mu, psf_cov = _psf_to_numpy(psf)
        ost = {
            "shape": (h, w), "sky": float(sky), "iota": float(iota), "wcs": wcs_np,
            "psf_w": psf_w, "psf_mu": psf_mu, "psf_cov": psf_cov,
        }
        scene_srcs = []
        for s in sources:
            s_b = dict(s)
            s_b["flux"] = float(np.asarray(s[band_flux_key])[b])
            scene_srcs.append(s_b)
        lam = oracle_scene_lambda(scene_srcs, ost)
        counts = rng.poisson(lam).astype(np.float64)
        ost["counts"] = counts
        oracle_stamps.append(ost)
        stamps.append(
            Stamp(
                counts=torch.as_tensor(counts, **kw),
                sky=torch.full((h, w), sky, **kw),
                iota=torch.tensor(iota, **kw),
                mask=torch.ones((h, w), **kw),
                psf=psf,
                wcs_A=dev_A,
                wcs_p0=dev_p0,
                band=b,
            )
        )
    return SyntheticScene(sources=list(sources), stamps=stamps, oracle_stamps=oracle_stamps,
                          wcs=wcs, bands=tuple(BANDS[b] for b in bands))


def star_source(u=(30.0, 10.0), flux_r=20.0, colors=None):
    """Oracle-style star dict with a plausible ugriz SED around flux_r."""
    if colors is None:
        colors = np.array([0.3, 0.7, 1.0, 1.15, 1.2])  # relative band throughput
    flux = flux_r * np.asarray(colors) / colors[2]
    return {"type": "star", "u": np.asarray(u, np.float64), "flux": flux}


def galaxy_source(u=(30.0, 10.0), flux_r=40.0, theta_dev=0.4, sigma=1.5, ab=0.6,
                  phi=0.7, colors=None):
    if colors is None:
        colors = np.array([0.25, 0.6, 1.0, 1.3, 1.5])
    flux = flux_r * np.asarray(colors) / colors[2]
    return {"type": "galaxy", "u": np.asarray(u, np.float64), "flux": flux,
            "theta_dev": float(theta_dev), "sigma": float(sigma), "ab": float(ab),
            "phi": float(phi)}
