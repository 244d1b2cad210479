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
