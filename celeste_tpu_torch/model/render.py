"""The dense forward model: source params -> pixel-space field MoG ->
expected-count image lambda.

Counterpart of ``celeste_tpu/model/render.py``.  This is the differentiable
reference path; ``kernels/mog_field.py`` evaluates the same field MoG fused
with the Poisson reduction.  The unit-MoG functions accept batched params
([..., D] fields); ``expected_image`` renders one unbatched scene.
"""

from __future__ import annotations

import torch

from celeste_tpu_torch.model.galaxy import galaxy_profile_mog
from celeste_tpu_torch.model.params import GalaxyParams, StarParams, galaxy_shape_cov_arcsec
from celeste_tpu_torch.model.stamp import Stamp
from celeste_tpu_torch.mog import MoG2D, concat, convolve, eval_grid


def star_unit_mog(params: StarParams, stamp: Stamp) -> MoG2D:
    """Unit-flux point-source profile: the PSF translated to the source's
    pixel position."""
    p = stamp.duas2pixel(params.u)
    return stamp.psf.shift(p)


def galaxy_unit_mog(params: GalaxyParams, stamp: Stamp) -> MoG2D:
    """Unit-flux galaxy profile convolved with the PSF, translated to the
    source position."""
    p = stamp.duas2pixel(params.u)
    j = stamp.sky_jacobian_arcsec()
    w_sky = galaxy_shape_cov_arcsec(None, params.sigma, params.ab, params.phi)
    w_px = _congruence_2x2(j, w_sky)
    gal = galaxy_profile_mog(params.theta_dev, w_px)
    return convolve(gal, stamp.psf).shift(p)


def _congruence_2x2(j, w):
    """J @ W @ J^T for 2x2, written elementwise."""
    a, b = j[..., 0, 0], j[..., 0, 1]
    c, d = j[..., 1, 0], j[..., 1, 1]
    wxx, wxy, wyy = w[..., 0, 0], w[..., 0, 1], w[..., 1, 1]
    # rows of J @ W
    r0x = a * wxx + b * wxy
    r0y = a * wxy + b * wyy
    r1x = c * wxx + d * wxy
    r1y = c * wxy + d * wyy
    oxx = r0x * a + r0y * b
    oxy = r0x * c + r0y * d
    oyy = r1x * c + r1y * d
    return torch.stack(
        [torch.stack([oxx, oxy], dim=-1), torch.stack([oxy, oyy], dim=-1)], dim=-2)


def source_unit_mog(params, stamp: Stamp) -> MoG2D:
    if isinstance(params, StarParams):
        return star_unit_mog(params, stamp)
    if isinstance(params, GalaxyParams):
        return galaxy_unit_mog(params, stamp)
    raise TypeError(f"unknown source params type {type(params)}")


def field_mog(sources, stamp: Stamp, band) -> MoG2D:
    """Flatten a list of Star/GalaxyParams into ONE pixel-space MoG whose
    weights are expected counts (iota * flux_band * unit weight)."""
    parts = []
    for src in sources:
        unit = source_unit_mog(src, stamp)
        amp = stamp.iota * src.flux[..., band]
        parts.append(unit.scale_weights(amp[..., None]))
    return concat(parts) if len(parts) > 1 else parts[0]


def expected_image(sources, stamp: Stamp, band=None):
    """lambda [H, W]: expected photo-electron counts of the whole scene."""
    if band is None:
        band = stamp.band
    m = field_mog(sources, stamp, band)
    px, py = stamp.pixel_grid()
    lam = eval_grid(m, px, py).reshape(stamp.counts.shape)
    return stamp.sky + lam
