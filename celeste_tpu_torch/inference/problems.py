"""Posterior factories: model + likelihood + priors as batched log-density
functions ``[B, D] -> [B]`` over unconstrained parameters (counterpart of
``celeste_tpu/inference/problems.py``).

The prior is evaluated in constrained space plus the reparameterisation
log |det J|.  The likelihood goes through the fused stamp kernel
(``kernels.mog_field.batched_stamp_loglik``, K1 on the card), one call per
stamp: a five-band star or galaxy is five launches in each direction,
where the JAX package renders a stack of the bands densely in one vmapped
program (``model.stamp.stack_stamps`` is ported for parity).
"""

from __future__ import annotations

from typing import Sequence

from celeste_tpu_torch.kernels.mog_field import batched_stamp_loglik, stamp_pixel_data
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.priors import SourcePriors


def _make_multi_loglik(stamps, bands, kind: str, n_bands: int):
    """Sum over the stamps of the fused log-likelihood, [B, D] -> [B]; a
    band indexes each stamp's flux slot."""
    stamps = list(stamps)
    bands = list(bands)
    pixel_data = [stamp_pixel_data(s) for s in stamps]

    def loglik(vecs):
        ll = 0.0
        for stamp, band, pd in zip(stamps, bands, pixel_data):
            ll = ll + batched_stamp_loglik(vecs, stamp, band=band, kind=kind, n_bands=n_bands,
                                           pixel_data=pd)
        return ll

    return loglik


def make_star_logdensity(stamps: Sequence, bands: Sequence[int],
                         priors: SourcePriors | None = None, n_bands: int = 5):
    """Single point source observed in ``stamps`` (one per entry of
    ``bands``).  BASELINE configs 1 (one stamp) and 2 (five bands)."""
    priors = priors or SourcePriors()
    loglik = _make_multi_loglik(stamps, bands, "star", n_bands)

    def logdensity(vecs):
        params = StarParams.from_vector(vecs, n_bands)
        return (loglik(vecs) + priors.star_logpdf(params)
                + StarParams.log_det_jacobian(vecs, n_bands))

    return logdensity


def make_galaxy_logdensity(stamps: Sequence, bands: Sequence[int],
                           priors: SourcePriors | None = None, n_bands: int = 5):
    """Single galaxy source (BASELINE config 3)."""
    priors = priors or SourcePriors()
    loglik = _make_multi_loglik(stamps, bands, "galaxy", n_bands)

    def logdensity(vecs):
        params = GalaxyParams.from_vector(vecs, n_bands)
        return (loglik(vecs) + priors.galaxy_logpdf(params)
                + GalaxyParams.log_det_jacobian(vecs, n_bands))

    return logdensity
