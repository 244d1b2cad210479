"""Per-pixel Poisson log-likelihood terms, shared by the dense path and the
kernel's plain version (counterpart of ``celeste_tpu/likelihood/_pixel.py``;
``csrc/mog_field.cu`` computes the same term per pixel).

``centered=True`` computes the log-likelihood relative to the saturated
model (lambda = x): per pixel ``x (log lam - log x~) + (x - lam)`` with
``x~ = max(x, eps)``.  That subtracts a parameter-independent constant per
pixel, so the posterior and every gradient are unchanged while the summed
magnitude drops from O(sum x log x) to O(chi^2 / 2), which keeps float32
energy differences resolvable for HMC.  Uncentered is the default.
"""

import torch

LAMBDA_MIN = 1e-10


def pixel_loglik(lam, counts, centered: bool):
    """Per-pixel Poisson log-likelihood terms (no mask, no reduction).
    ``lam`` may be pre- or post-clamp: the clamp is applied here."""
    lam = torch.clamp(lam, min=LAMBDA_MIN)
    if centered:
        xt = torch.clamp(counts, min=LAMBDA_MIN)
        return counts * (torch.log(lam) - torch.log(xt)) + (counts - lam)
    return counts * torch.log(lam) - lam
