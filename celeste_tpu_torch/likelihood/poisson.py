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
