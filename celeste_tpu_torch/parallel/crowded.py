"""Crowded-field joint inference on one device: BASELINE config 5, many
overlapping sources sampled jointly by a chain ensemble.

Counterpart of the single-device part of ``celeste_tpu/parallel/crowded.py``.
The joint state packs every source's unconstrained vector in scene order
(star blocks 2+B wide, galaxy blocks 6+B wide); log-densities take a
[B, D_total] batch of chains and return [B].

- :func:`make_crowded_logdensity` is the dense reference: the whole scene as
  one MoG field through the stamp kernel (K1 on the card).
- :func:`make_tiled_crowded_logdensity` is the production path: block-sparse
  tiles through the tiled kernels (K2 for values, K3 + K4 for gradients).

The source-sharded paths (``sharded_crowded_loglik``,
``sharded_tiled_crowded_loglik``) and the rectangular star-padded layout
they use are multi-GPU work, not yet ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from celeste_tpu_torch.kernels.mog_field import _field_planes, mog_field_loglik, stamp_pixel_data
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.priors import SourcePriors


def STAR_D(n_bands):
    return 2 + n_bands


def GAL_D(n_bands):
    return 6 + n_bands


@dataclass(frozen=True)
class CrowdedScene:
    """Static description of a multi-source problem on one field.

    ``kinds``: per-source 'star' / 'galaxy'; it fixes the joint vector's
    layout (sources packed in order, star blocks 2+B wide, galaxy blocks 6+B).
    """

    kinds: Tuple[str, ...]
    n_bands: int = 5

    @property
    def n_sources(self):
        return len(self.kinds)

    def block_slices(self):
        """([(offset, width, kind) per source], total width)."""
        out, off = [], 0
        for k in self.kinds:
            d = STAR_D(self.n_bands) if k == "star" else GAL_D(self.n_bands)
            out.append((off, d, k))
            off += d
        return out, off

    @property
    def dim(self):
        return self.block_slices()[1]

    def unpack(self, vecs):
        """Joint [..., D_total] vectors -> list of Star/GalaxyParams."""
        blocks, _ = self.block_slices()
        params = []
        for off, d, kind in blocks:
            v = vecs[..., off:off + d]
            cls = StarParams if kind == "star" else GalaxyParams
            params.append(cls.from_vector(v, self.n_bands))
        return params


def scene_field_planes(scene: CrowdedScene, vecs, stamp, band):
    """[B, D_total] joint vectors -> six [B, C_total] planes, every source's
    components concatenated in scene order."""
    blocks, _ = scene.block_slices()
    planes = [_field_planes(vecs[:, off:off + d], stamp, band, kind, scene.n_bands)
              for off, d, kind in blocks]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*planes))


def _crowded_logprior(scene: CrowdedScene, priors: SourcePriors, vecs):
    """Prior + log |det J| of every source, [B]."""
    lp = 0.0
    blocks, _ = scene.block_slices()
    for (off, d, kind), params in zip(blocks, scene.unpack(vecs)):
        v = vecs[..., off:off + d]
        if kind == "star":
            lp = lp + priors.star_logpdf(params) + StarParams.log_det_jacobian(v, scene.n_bands)
        else:
            lp = (lp + priors.galaxy_logpdf(params)
                  + GalaxyParams.log_det_jacobian(v, scene.n_bands))
    return lp


def make_crowded_logdensity(scene: CrowdedScene, stamps: Sequence, bands: Sequence[int],
                            priors: SourcePriors | None = None, centered: bool = False):
    """Dense joint log density ``[B, D_total] -> [B]``: the whole scene as one
    MoG field through ``mog_field_loglik`` (K1-fwd on the card), one call per
    stamp.  ``centered=True`` computes each pixel term relative to the
    saturated model (same posterior and gradients, ~1000x smaller fp32
    magnitude; ``likelihood/_pixel.py``).

    On the card its gradient runs K1-bwd, whose shared memory caps a stamp
    at about 4.4k pixels: on a larger field (config 5's is 6144) a gradient
    raises, and the dense path serves values only.
    """
    priors = priors or SourcePriors()
    stamps = list(stamps)
    bands = list(bands)
    pixel_data = [stamp_pixel_data(s) for s in stamps]

    def logdensity(vecs):
        ll = 0.0
        for stamp, band, pd in zip(stamps, bands, pixel_data):
            planes = scene_field_planes(scene, vecs, stamp, band)
            ll = ll + mog_field_loglik(*planes, pd, centered=centered)
        return ll + _crowded_logprior(scene, priors, vecs)

    return logdensity


def make_tiled_crowded_logdensity(scene: CrowdedScene, stamp, band, positions_px,
                                  radii_px=12.0, priors: SourcePriors | None = None,
                                  s_max: int | None = None, n_buckets: int = 2,
                                  centered: bool = False):
    """Block-sparse tiled joint log density ``[B, D_total] -> [B]``.

    ``positions_px`` [S, 2]: approximate source pixel positions (catalog or
    detection), used only to build the static tile map; the sampled
    positions move freely within the support radii ``radii_px`` (a scalar,
    [S], or [S, N_GAL] per block from ``model.galaxy.block_support_radii``).
    Mixed-kind scenes use the component-block layout (slots K wide; a star
    owns one block, a galaxy N_GAL), so per-tile work tracks the true
    component count.  Returns ``(logdensity, TiledStampData)``.

    One band: a list of stamps (multi-band joint fields) is not yet ported.
    """
    from celeste_tpu_torch.kernels.tiled_field import (
        TiledStampData,
        scene_planes_blocked,
        scene_planes_padded,
        tiled_field_loglik,
    )
    from celeste_tpu_torch.model.galaxy import N_GAL
    from celeste_tpu_torch.parallel.tiles import build_block_tile_map, build_tile_map

    if isinstance(stamp, (list, tuple)) or isinstance(band, (list, tuple)):
        raise NotImplementedError("multi-band tiled crowded fields are not yet ported to "
                                  "celeste_tpu_torch (see ROADMAP.md)")
    priors = priors or SourcePriors()
    mixed = len(set(scene.kinds)) > 1
    k_psf = stamp.psf.n_components
    n_comp = k_psf if mixed or scene.kinds[0] == "star" else N_GAL * k_psf
    pos = np.asarray(positions_px)
    if pos.shape != (scene.n_sources, 2):
        raise ValueError(f"positions must be [{scene.n_sources}, 2], got {pos.shape}")
    shape = tuple(stamp.counts.shape)
    if mixed:
        tm = build_block_tile_map(pos, radii_px, scene.kinds, shape, n_blocks_gal=N_GAL,
                                  s_max=s_max)
    else:
        tm = build_tile_map(pos, radii_px, shape, s_max=s_max)
    data = TiledStampData(tm, stamp, n_buckets=n_buckets)
    planes_fn = scene_planes_blocked if mixed else scene_planes_padded

    def logdensity(vecs):
        planes = planes_fn(scene, vecs, stamp, band)
        ll = tiled_field_loglik(planes, data, n_comp=n_comp, centered=centered)
        return ll + _crowded_logprior(scene, priors, vecs)

    return logdensity, data
