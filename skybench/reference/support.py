"""The support-radius rule of the crowded field's component blocks, frozen.

A component block of table weight a_j and total standard deviation sigma_j
contributes less than ``rel_eps`` of a unit-flux source outside
``r_j = sigma_j sqrt(2 ln(a_j / rel_eps)) + slack_px``; a block with
a_j <= rel_eps gets radius -1 and is dropped.  A star owns one block, the
PSF alone, in column 0.
"""

from __future__ import annotations

import numpy as np

from skybench.reference.tables import DEV_AMPS, DEV_VARS, EXP_AMPS, EXP_VARS

N_GAL = len(EXP_AMPS) + len(DEV_AMPS)
AMPS = np.concatenate([EXP_AMPS, DEV_AMPS])
VARS = np.concatenate([EXP_VARS, DEV_VARS])


def block_support_radii(kinds, psf_sigma_px, gal_sigma_px, rel_eps=1e-4, slack_px=2.0):
    """Per-block support radii [S, N_GAL] in pixels; -1 marks a block that
    is dropped."""
    sig_g = np.sqrt(VARS * float(gal_sigma_px) ** 2 + float(psf_sigma_px) ** 2)
    with np.errstate(divide="ignore"):
        arg = 2.0 * np.log(AMPS / rel_eps)
    r_gal = np.where(AMPS > rel_eps, sig_g * np.sqrt(np.maximum(arg, 0.0)) + slack_px, -1.0)
    r_star = float(psf_sigma_px) * np.sqrt(2.0 * np.log(1.0 / rel_eps)) + slack_px
    out = np.full((len(kinds), N_GAL), -1.0)
    for i, kind in enumerate(kinds):
        if kind == "star":
            out[i, 0] = r_star
        else:
            out[i] = r_gal
    return out
