"""Per-pixel Poisson log-likelihood (counterpart of
``celeste_tpu/likelihood/poisson.py``).

log p(x | Theta) = sum_m [ x_m log lambda_m - lambda_m - log(x_m!) ]

The ``log(x_m!)`` term is constant in the parameters and dropped by
default; ``normalized=True`` keeps it for absolute comparisons.
"""

from __future__ import annotations

import torch

from celeste_tpu_torch.likelihood._pixel import LAMBDA_MIN, pixel_loglik  # noqa: F401
from celeste_tpu_torch.model.render import expected_image
from celeste_tpu_torch.model.stamp import Stamp
from celeste_tpu_torch.mog import MoG2D


def poisson_loglik(lam, counts, mask=None, normalized: bool = False,
                   centered: bool = False):
    """Reduce a lambda grid against observed counts over ALL axes -> scalar."""
    ll = pixel_loglik(lam, counts, centered)
    if normalized:
        ll = ll - torch.lgamma(counts + 1.0)
    if mask is not None:
        ll = ll * mask
    return torch.sum(ll)


def stamp_loglik(sources, stamp, band=None, normalized: bool = False,
                 centered: bool = False):
    """Dense path: render the scene, then reduce.  Differentiable end to
    end; the fused path is ``kernels.mog_field.batched_stamp_loglik``."""
    lam = expected_image(sources, stamp, band)
    return poisson_loglik(lam, stamp.counts, stamp.mask, normalized, centered)


def multi_stamp_loglik(sources, stamps, normalized: bool = False,
                       centered: bool = False):
    """Sum of the per-band stamp log-likelihoods: ``stamps`` is a stacked
    Stamp (``model.stamp.stack_stamps``) with a leading band axis, each
    band's stamp rendered with its own band index."""
    total = 0.0
    for i in range(stamps.counts.shape[0]):
        st = Stamp(stamps.counts[i], stamps.sky[i], stamps.iota[i], stamps.mask[i],
                   MoG2D(stamps.psf.w[i], stamps.psf.mu[i], stamps.psf.cov[i]),
                   stamps.wcs_A[i], stamps.wcs_p0[i], int(stamps.band[i]))
        total = total + stamp_loglik(sources, st, band=st.band, normalized=normalized,
                                     centered=centered)
    return total
