"""Posterior factories: model + likelihood + priors as batched log-density
functions ``[B, D] -> [B]`` over unconstrained parameters (counterpart of
``celeste_tpu/inference/problems.py``).

The prior is evaluated in constrained space plus the reparameterisation
log |det J|.  The likelihood goes through the fused stamp kernel
(``kernels.mog_field.batched_stamp_loglik``), one call per stamp; the JAX
package renders the same function densely.
"""

from __future__ import annotations

from typing import Sequence

from celeste_tpu_torch.kernels.mog_field import batched_stamp_loglik, stamp_pixel_data
from celeste_tpu_torch.model.params import StarParams
from celeste_tpu_torch.model.priors import SourcePriors


def make_star_logdensity(stamps: Sequence, bands: Sequence[int],
                         priors: SourcePriors | None = None, n_bands: int = 5):
    """Single point source observed in ``stamps`` (one per entry of
    ``bands``; a band indexes each stamp's flux slot).  BASELINE config 1
    with one stamp."""
    priors = priors or SourcePriors()
    stamps = list(stamps)
    bands = list(bands)
    pixel_data = [stamp_pixel_data(s) for s in stamps]

    def logdensity(vecs):
        params = StarParams.from_vector(vecs, n_bands)
        ll = 0.0
        for stamp, band, pd in zip(stamps, bands, pixel_data):
            ll = ll + batched_stamp_loglik(vecs, stamp, band=band, kind="star",
                                           n_bands=n_bands, pixel_data=pd)
        lp = priors.star_logpdf(params)
        ljd = StarParams.log_det_jacobian(vecs, n_bands)
        return ll + lp + ljd

    return logdensity
