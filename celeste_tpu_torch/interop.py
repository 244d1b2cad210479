"""Carry state across from the JAX package as NumPy arrays.

Every function takes NumPy arrays (or array-likes) only, named like the
fields of the JAX package's pytrees, and returns this package's objects on
``device``.  The tests use them to feed one scene and one chain state to
both packages.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from celeste_tpu_torch.inference.chees import ChEESState
from celeste_tpu_torch.inference.hmc import HMCState
from celeste_tpu_torch.model.color_prior import ColorGMM
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


def color_gmm_from_fields(weights, means, inv_chols) -> ColorGMM:
    """A ``ColorGMM`` from the JAX one's fields (weights [K], means [K][C],
    inv_chols [K][C][C]), as nested float tuples."""
    return ColorGMM(weights=tuple(float(v) for v in np.asarray(weights, np.float64)),
                    means=tuple(map(tuple, np.asarray(means, np.float64).tolist())),
                    inv_chols=tuple(tuple(map(tuple, m))
                                    for m in np.asarray(inv_chols, np.float64).tolist()))


def hmc_warm_state_from_numpy(x, logp, grad, step_size, inv_mass, device="cpu"):
    """An HMC warm state of B chains: (HMCState with x [B, D], logp [B],
    grad [B, D]; step_size; inv_mass), as a per-chain warmup leaves them."""
    state = HMCState(x=_t(x, device), logp=_t(logp, device), grad=_t(grad, device))
    return state, _t(step_size, device), _t(inv_mass, device)


def chees_state_from_numpy(xs, logps, grads, device="cpu") -> ChEESState:
    """A ChEES ensemble state: xs [B, D], logps [B], grads [B, D]."""
    return ChEESState(xs=_t(xs, device), logps=_t(logps, device), grads=_t(grads, device))


# leaves of a config-5 preparation artifact, in the pytree order the JAX
# package's checkpoint writes them (dict keys sorted; HMCState as x, logp, grad)
_PREP_LEAVES = ("cov_hat", "inv_mass", "m_hat", "states_x.x", "states_x.logp", "states_x.grad",
                "states_z.x", "states_z.logp", "states_z.grad", "step_size", "step_z")


def load_config5_prep(path, device="cpu"):
    """Load a config-5 warm-start artifact of the JAX package
    (``celeste_tpu/bench/artifacts/config5_prep.npz``): plain arrays
    ``leaf_0..leaf_10`` whose pytree order ``__meta__`` records.

    Returns a dict: ``m_hat`` [D] and ``cov_hat`` [D, D] (the whitening
    moments), ``inv_mass`` [D], ``states_x`` and ``states_z`` (HMCStates of
    the warmed x-space and z-space ensembles), ``step_size`` and ``step_z``
    (floats) and ``meta`` (the artifact's own metadata).  The saved ``logp``
    fields are whatever the code of the day computed; compare them with a
    live evaluation before trusting them.
    """
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        if meta.get("n_leaves") != len(_PREP_LEAVES) or "states_z" not in meta["treedef"]:
            raise ValueError(f"{path} is not a config-5 preparation artifact: {meta}")
        leaves = {name: np.asarray(f[f"leaf_{i}"]) for i, name in enumerate(_PREP_LEAVES)}
    out = {"meta": meta, "step_size": float(leaves["step_size"]),
           "step_z": float(leaves["step_z"])}
    for name in ("m_hat", "cov_hat", "inv_mass"):
        out[name] = _t(leaves[name], device)
    for name in ("states_x", "states_z"):
        out[name] = HMCState(x=_t(leaves[f"{name}.x"], device),
                             logp=_t(leaves[f"{name}.logp"], device),
                             grad=_t(leaves[f"{name}.grad"], device))
    return out
