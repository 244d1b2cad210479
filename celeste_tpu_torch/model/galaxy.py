"""Galaxy profile mixtures: the fixed exp/deV MoG tables and the
theta-mixed, shape-scaled galaxy profile.

Counterpart of ``celeste_tpu/model/galaxy.py``.  The circular unit profile
is a fixed mixture ``sum_j a_j N(x; 0, v_j I)``; an elliptical galaxy scales
each component's covariance by its pixel-space shape matrix.  Convolution
with the PSF happens in ``render.galaxy_unit_mog``.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.model._profile_tables import DEV_AMPS, DEV_VARS, EXP_AMPS, EXP_VARS
from celeste_tpu_torch.mog import MoG2D

N_EXP = len(EXP_AMPS)   # 6
N_DEV = len(DEV_AMPS)   # 10
N_GAL = N_EXP + N_DEV   # components of the theta-mixed profile

_VARS = np.concatenate([EXP_VARS, DEV_VARS])


def galaxy_profile_mog(theta_dev, shape_cov_px) -> MoG2D:
    """Unit-flux galaxy profile in pixel coordinates, before PSF convolution.

    theta_dev : [...] in (0, 1) — fraction of flux in the deV component.
    shape_cov_px : [..., 2, 2] — pixel-space shape covariance ``J W_sky J^T``.

    Returns a MoG2D with N_GAL zero-centered components per batch entry;
    weights sum to 1.
    """
    kw = dict(dtype=torch.float32, device=theta_dev.device)
    amps_exp = torch.as_tensor(EXP_AMPS, **kw)
    amps_dev = torch.as_tensor(DEV_AMPS, **kw)
    theta = theta_dev[..., None]
    w = torch.cat([(1.0 - theta) * amps_exp, theta * amps_dev], dim=-1)
    vars_ = torch.as_tensor(_VARS, **kw)
    cov = vars_[:, None, None] * shape_cov_px[..., None, :, :]
    mu = torch.zeros(*theta_dev.shape, N_GAL, 2, **kw)
    return MoG2D(w, mu, cov)


def block_support_radii(kinds, psf_sigma_px, gal_sigma_px, rel_eps: float = 1e-4,
                        slack_px: float = 2.0):
    """Per-block support radii [S, N_GAL] for ``parallel.tiles.build_block_tile_map``.

    A component block of table weight a_j and total std sigma_j contributes
    less than ``rel_eps`` of a unit-flux source outside
    ``r_j = sigma_j sqrt(2 ln(a_j / rel_eps)) + slack_px``; blocks with
    a_j <= rel_eps get radius -1 and are dropped from every tile.  Star
    rows hold the PSF-only radius in column 0 (a star owns one block).
    ``psf_sigma_px`` is the widest PSF component's std, ``gal_sigma_px`` an
    upper estimate of the galaxy half-light radius (pixels); ``slack_px``
    covers the sampled positions' movement.  NumPy, as in the JAX package.
    """
    kinds = list(kinds)
    amps = np.concatenate([np.asarray(EXP_AMPS), np.asarray(DEV_AMPS)])
    sig_g = np.sqrt(_VARS * float(gal_sigma_px) ** 2 + float(psf_sigma_px) ** 2)
    with np.errstate(divide="ignore"):
        arg = 2.0 * np.log(amps / rel_eps)
    r_gal = np.where(amps > rel_eps, sig_g * np.sqrt(np.maximum(arg, 0.0)) + slack_px, -1.0)
    r_star = float(psf_sigma_px) * np.sqrt(2.0 * np.log(1.0 / rel_eps)) + slack_px
    out = np.full((len(kinds), N_GAL), -1.0)
    for i, kind in enumerate(kinds):
        if kind == "star":
            out[i, 0] = r_star
        else:
            out[i] = r_gal
    return out
