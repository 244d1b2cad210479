"""Carry state across from the JAX package as NumPy arrays.

Every function takes NumPy arrays (or array-likes) only, named like the
fields of the JAX package's pytrees, and returns this package's objects on
``device``.  The tests use them to feed one scene and one chain state to
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.inference.hmc import HMCState
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.stamp import Stamp
from celeste_tpu_torch.mog import MoG2D


def _t(x, device):
    # np.array copies, so read-only buffers (a JAX array's) are never shared
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def stamp_from_numpy(counts, sky, iota, mask, psf_w, psf_mu, psf_cov, wcs_A, wcs_p0,
                     band, device="cpu") -> Stamp:
    """A ``Stamp`` from the JAX ``Stamp`` fields (its PSF given as w, mu, cov)."""
    return Stamp(counts=_t(counts, device), sky=_t(sky, device), iota=_t(iota, device),
                 mask=_t(mask, device),
                 psf=MoG2D(_t(psf_w, device), _t(psf_mu, device), _t(psf_cov, device)),
                 wcs_A=_t(wcs_A, device), wcs_p0=_t(wcs_p0, device), band=int(band))


def star_params_from_numpy(u, flux, device="cpu") -> StarParams:
    return StarParams(u=_t(u, device), flux=_t(flux, device))


def galaxy_params_from_numpy(u, flux, theta_dev, sigma, ab, phi, device="cpu") -> GalaxyParams:
    return GalaxyParams(u=_t(u, device), flux=_t(flux, device),
                        theta_dev=_t(theta_dev, device), sigma=_t(sigma, device),
                        ab=_t(ab, device), phi=_t(phi, device))


def hmc_warm_state_from_numpy(x, logp, grad, step_size, inv_mass, device="cpu"):
    """An HMC warm state of B chains: (HMCState with x [B, D], logp [B],
    grad [B, D]; step_size; inv_mass), as a per-chain warmup leaves them."""
    state = HMCState(x=_t(x, device), logp=_t(logp, device), grad=_t(grad, device))
    return state, _t(step_size, device), _t(inv_mass, device)
