"""Carry state across from the JAX package as NumPy arrays.

Every function takes NumPy arrays (or array-likes) only, named like the
fields of the JAX package's pytrees, and returns this package's objects on
``device``.  The tests use them to feed one scene and one chain state to
both packages.
"""

from __future__ import annotations

import json
import re

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


# the namedtuples in the JAX package's config-5 artifacts: this package's
# class and the fields in pytree order
_NAMEDTUPLES = {"HMCState": (HMCState, ("x", "logp", "grad")),
                "ChEESState": (ChEESState, ("xs", "logps", "grads"))}
# the top-level keys of the two kinds of artifact: the shared preparation
# flow's output and the ChEES arm's adapted ensemble
_PREP_KEYS = {"cov_hat", "inv_mass", "m_hat", "states_x", "states_z", "step_size", "step_z"}
_CHEES_KEYS = {"eps", "st", "traj"}


def _leaf_order(treedef: str):
    """[(key, namedtuple name or None)] of a checkpoint's flat dict of
    arrays and namedtuples of arrays, in leaf order, from the ``treedef``
    string its ``__meta__`` records."""
    out = []
    for m in re.finditer(r"'(\w+)': (?:\*|CustomNode\(namedtuple\[(\w+)\], \[([*, ]*)\]\))",
                         treedef):
        key, name, stars = m.groups()
        if name is not None and (name not in _NAMEDTUPLES
                                 or stars.count("*") != len(_NAMEDTUPLES[name][1])):
            raise ValueError(f"unknown namedtuple {name}[{stars}] in {treedef}")
        out.append((key, name))
    return out


def load_config5_prep(path, device="cpu"):
    """Load a config-5 warm-start artifact of the JAX package: plain arrays
    ``leaf_0..leaf_N`` whose pytree order the file's own ``__meta__``
    records (its keys sorted, a namedtuple's fields in order).

    Two kinds (``celeste_tpu/bench/artifacts/``): the preparation flow's
    output (``config5_prep.npz``, ``config5_multiband_prep.npz``) gives
    ``m_hat`` [D] and ``cov_hat`` [D, D] (the whitening moments),
    ``inv_mass`` [D], ``states_x`` and ``states_z`` (HMCStates of the warmed
    x-space and z-space ensembles) and ``step_size`` and ``step_z``; the
    ChEES arm's adaptation (``config5_multiband_chees_prep.npz``) gives
    ``st`` (a ChEESState of z-space chains), ``eps`` and ``traj``.  Scalars
    come back as floats, arrays as tensors on ``device``; ``meta`` is the
    artifact's own metadata.  The saved ``logp`` / ``logps`` fields are
    whatever the code of the day computed; compare them with a live
    evaluation before trusting them.
    """
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        order = _leaf_order(meta.get("treedef", ""))
        keys = {k for k, _ in order}
        n = sum(len(_NAMEDTUPLES[name][1]) if name else 1 for _, name in order)
        if keys not in (_PREP_KEYS, _CHEES_KEYS) or meta.get("n_leaves") != n:
            raise ValueError(f"{path} is not a config-5 warm-start artifact: {meta}")
        leaves = iter(np.asarray(f[f"leaf_{i}"]) for i in range(n))
        out = {"meta": meta}
        for key, name in order:
            if name is None:
                a = next(leaves)
                out[key] = float(a) if a.ndim == 0 else _t(a, device)
            else:
                cls, fields = _NAMEDTUPLES[name]
                out[key] = cls(**{fld: _t(next(leaves), device) for fld in fields})
    return out
