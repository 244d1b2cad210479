"""Crowded-field joint inference: BASELINE config 5, many overlapping
sources sampled jointly by a chain ensemble, on one device or sharded over
a mesh of ranks (counterpart of ``celeste_tpu/parallel/crowded.py``).

The joint state packs every source's unconstrained vector in scene order
(star blocks 2+B wide, galaxy blocks 6+B wide); log-densities take a
[B, D_total] batch of chains and return [B].

- :func:`make_crowded_logdensity` is the dense reference: the whole scene as
  one MoG field through the stamp kernel (K1 on the card).
- :func:`make_tiled_crowded_logdensity` is the production path on one
  device: block-sparse tiles through the tiled kernels (K2 for values,
  K3 + K4 for gradients), in one band or jointly in several.

The sharded paths split the sources over the mesh's ``sources`` dimension
and the chains over ``chains``.  The expected image is additive, lambda =
sky + sum_s lambda_s, so each rank renders its own sources' sky-free
lambda, the ranks of a ``sources`` group sum it, and sky and the Poisson
log come after the sum.  Their state is rectangular, [B, S, 6+B] (a star
row carries inert padding after its 2+B slots, anchored by
:func:`crowded_rect_logprior`).  Each rank holds its chains with every
source row, alike across its ``sources`` group, and the log-likelihood
reads its own rows; the gradient conjugates of ``collectives.py``
(``replicated_in`` before the rows are read, ``sum_over`` for the lambda
sum) give every rank the single-process gradient.

- :func:`sharded_crowded_loglik`: dense lambda over every pixel, plain
  PyTorch (the JAX function has no Pallas kernel);
- :func:`sharded_tiled_crowded_loglik`: block-sparse lambda tiles through
  K5 (``kernels.tiled_field.render_bucket``), with K6 as its gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence, Tuple

import numpy as np
import torch

import torch.nn.functional as F

from celeste_tpu_torch.kernels.mog_field import (
    _field_planes,
    mixed_field_planes,
    mog_field_loglik,
    stamp_pixel_data,
)
from celeste_tpu_torch.likelihood._pixel import pixel_loglik
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.priors import SourcePriors
from celeste_tpu_torch.parallel.collectives import replicated_in, sum_over
from celeste_tpu_torch.parallel.mesh import axis_index, axis_size
from celeste_tpu_torch.utils.profiling import span


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

    # -- the rectangular (star-padded) layout of the sharded paths: every
    # source row has the galaxy width; a star row uses its first 2+B slots.
    # Tensors and NumPy arrays alike.

    @property
    def rect_dim(self):
        return GAL_D(self.n_bands)

    @property
    def is_star_flags(self):
        return np.asarray([k == "star" for k in self.kinds])

    def to_rect(self, vecs):
        """Packed joint [..., D_total] -> rectangular [..., S, GAL_D]."""
        blocks, _ = self.block_slices()
        rows = []
        for off, d, _ in blocks:
            v, pad = vecs[..., off:off + d], self.rect_dim - d
            if isinstance(v, torch.Tensor):
                rows.append(F.pad(v, (0, pad)))
            else:
                rows.append(np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, pad)]))
        return torch.stack(rows, -2) if isinstance(vecs, torch.Tensor) else np.stack(rows, -2)

    def from_rect(self, rect):
        """Rectangular [..., S, GAL_D] -> packed joint [..., D_total]."""
        blocks, _ = self.block_slices()
        parts = [rect[..., i, :d] for i, (_, d, _) in enumerate(blocks)]
        return torch.cat(parts, -1) if isinstance(rect, torch.Tensor) else np.concatenate(parts, -1)


def scene_field_planes(scene: CrowdedScene, vecs, stamp, band):
    """[B, D_total] joint vectors -> six [B, C_total] planes, every source's
    components concatenated in scene order."""
    blocks, _ = scene.block_slices()
    planes = [_field_planes(vecs[:, off:off + d], stamp, band, kind, scene.n_bands)
              for off, d, kind in blocks]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*planes))


def _crowded_logprior(scene: CrowdedScene, priors: SourcePriors, vecs):
    """Prior + log |det J| of every source, [B]."""
    with span("posterior.prior"):
        lp = 0.0
        blocks, _ = scene.block_slices()
        for (off, d, kind), params in zip(blocks, scene.unpack(vecs)):
            v = vecs[..., off:off + d]
            if kind == "star":
                lp = (lp + priors.star_logpdf(params)
                      + StarParams.log_det_jacobian(v, scene.n_bands))
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

    On the card its gradient runs K1-bwd, which stages the pixels in chunks
    and so takes any field; config 5's 48x128 field (6144 pixels, 126
    components) takes its gradient there too.
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
    detection), used only to build the static tile maps; the sampled
    positions move freely within the support radii ``radii_px`` (a scalar,
    [S], or [S, N_GAL] per block from ``model.galaxy.block_support_radii``).
    Mixed-kind scenes use the component-block layout (slots K wide; a star
    owns one block, a galaxy N_GAL), so per-tile work tracks the true
    component count.  Every band's planes come from one call of
    ``kernels.scene_planes.ScenePlanes``: on the card one launch of its
    forward kernel, and one of its backward under autograd.  The prior of
    every source comes from one call of ``kernels.scene_prior.ScenePrior``
    (one launch each way on the card) where the colours are Gaussian; a
    ``ColorGMM`` colour prior keeps :func:`_crowded_logprior`.

    ``stamp`` and ``band`` may be lists, one entry per band, for a joint
    multi-band field: one tile map and one ``TiledStampData`` per band, and
    the log-likelihood summed over the bands (one K2, or K3 and K4, launch
    per band and occupancy bucket).  The bands share one PSF component
    count.  ``positions_px`` is then one [S, 2] array shared by the bands
    (co-registered cutouts) or a list of per-band [S, 2] arrays; a stacked
    [n_bands, S, 2] array is ambiguous and raises.  Returns ``(logdensity,
    data)``: the ``TiledStampData``, or their list when ``stamp`` is a list.
    """
    from celeste_tpu_torch.kernels.scene_planes import ScenePlanes
    from celeste_tpu_torch.kernels.scene_prior import ScenePrior
    from celeste_tpu_torch.kernels.tiled_field import TiledStampData, tiled_field_loglik
    from celeste_tpu_torch.model.galaxy import N_GAL
    from celeste_tpu_torch.parallel.tiles import build_block_tile_map, build_tile_map

    priors = priors or SourcePriors()
    mixed = len(set(scene.kinds)) > 1
    is_multi = isinstance(stamp, (list, tuple))
    stamps = list(stamp) if is_multi else [stamp]
    bands = list(band) if isinstance(band, (list, tuple)) else [band]
    if len(stamps) != len(bands):
        raise ValueError(f"{len(stamps)} stamps but {len(bands)} bands")
    k_psf = stamps[0].psf.n_components
    if any(s.psf.n_components != k_psf for s in stamps):
        raise ValueError("all bands must share the PSF component count (the per-chain planes "
                         "are reshaped with one n_comp)")
    n_comp = k_psf if mixed or scene.kinds[0] == "star" else N_GAL * k_psf
    per_band = (isinstance(positions_px, (list, tuple)) and len(positions_px) == len(stamps)
                and np.asarray(positions_px[0]).ndim == 2)
    positions = ([np.asarray(p) for p in positions_px] if per_band
                 else [np.asarray(positions_px)] * len(stamps))
    for pos in positions:
        if pos.shape != (scene.n_sources, 2):
            raise ValueError(f"positions must be [{scene.n_sources}, 2] per band; got "
                             f"{pos.shape} (a stacked [n_bands, S, 2] array is ambiguous: "
                             f"pass a list of per-band [S, 2] arrays)")
    datas = []
    for st, pos in zip(stamps, positions):
        shape = tuple(st.counts.shape)
        if mixed:
            tm = build_block_tile_map(pos, radii_px, scene.kinds, shape, n_blocks_gal=N_GAL,
                                      s_max=s_max)
        else:
            tm = build_tile_map(pos, radii_px, shape, s_max=s_max)
        datas.append(TiledStampData(tm, st, n_buckets=n_buckets))
    scene_planes = ScenePlanes(scene, stamps, bands)
    if priors.flux.color_gmm is None:
        prior = ScenePrior(scene, priors, stamps[0].counts.device)
    else:
        prior = partial(_crowded_logprior, scene, priors)

    def logdensity(vecs):
        with span("posterior.planes"):
            band_planes = scene_planes(vecs)
        ll = 0.0
        for planes, data in zip(band_planes, datas):
            with span("posterior.likelihood"):
                ll = ll + tiled_field_loglik(planes, data, n_comp=n_comp, centered=centered)
        return ll + prior(vecs)

    return logdensity, (datas if is_multi else datas[0])


def crowded_rect_logprior(scene: CrowdedScene, vecs, priors: SourcePriors | None = None):
    """Prior + log |det J| of the rectangular [..., S, GAL_D] state of the
    sharded paths, [...].  A star row takes the star prior on its first 2+B
    slots and a standard-normal anchor on its padding, so the joint stays
    proper under gradient samplers (the likelihood is flat there).  Every
    rank computes it on all rows; it is not reduced."""
    priors = priors or SourcePriors()
    nb = scene.n_bands
    sd, gd = STAR_D(nb), GAL_D(nb)
    lp = 0.0
    for i, kind in enumerate(scene.kinds):
        row = vecs[..., i, :]
        if kind == "star":
            v = row[..., :sd]
            lp = lp + priors.star_logpdf(StarParams.from_vector(v, nb))
            lp = lp + StarParams.log_det_jacobian(v, nb)
            pad = row[..., sd:gd]
            lp = lp - 0.5 * torch.sum(pad * pad, dim=-1)
        else:
            lp = lp + priors.galaxy_logpdf(GalaxyParams.from_vector(row, nb))
            lp = lp + GalaxyParams.log_det_jacobian(row, nb)
    return lp


class _LocalSources:
    """This rank's source rows and their planes, for both sharded paths."""

    def __init__(self, scene: CrowdedScene, stamp, band, mesh, n_bands):
        n_src = scene.n_sources
        n_shards = axis_size(mesh, "sources")
        if n_src % n_shards:
            raise ValueError(f"{n_src} sources do not divide over {n_shards} source shards")
        self.s_loc = n_src // n_shards
        start = axis_index(mesh, "sources") * self.s_loc
        self.rows = slice(start, start + self.s_loc)
        self.kinds = scene.kinds[self.rows]
        self.mixed = len(set(scene.kinds)) > 1
        self.stamp, self.band, self.mesh = stamp, band, mesh
        self.n_bands = n_bands or scene.n_bands
        self.is_star = torch.as_tensor(scene.is_star_flags[self.rows], device=stamp.counts.device)

    def planes(self, vecs):
        """[B, S, D_s] states (all rows, alike on the group) -> six planes
        [B, S_loc * C] of this rank's sources, source-major.  The backward
        of the rows' read sums the group's cotangents."""
        local = replicated_in(vecs, self.mesh, "sources")[:, self.rows]
        b = local.shape[0]
        flat = local.reshape(b * self.s_loc, local.shape[-1])
        if self.mixed:
            flags = self.is_star[None, :].expand(b, self.s_loc).reshape(-1)
            per = mixed_field_planes(flat, self.stamp, self.band, self.n_bands, flags)
        else:
            per = _field_planes(flat, self.stamp, self.band, self.kinds[0], self.n_bands)
        return tuple(p.reshape(b, -1) for p in per)


def _chunks(b: int, chunk: int):
    return [(c0, min(b, c0 + chunk)) for c0 in range(0, b, chunk)]


def sharded_crowded_loglik(scene: CrowdedScene, stamp, band, mesh, *, n_bands: int | None = None,
                           centered: bool = False):
    """The source-sharded log-likelihood over every pixel of ``stamp``:
    ``f(vecs [B, S, D_s]) -> [B]`` on this rank's chains, alike on every
    rank of its ``sources`` group.

    Uniform-kind scenes take D_s = the kind's width; mixed scenes the
    rectangular layout (D_s = GAL_D, ``CrowdedScene.to_rect``).  Each rank
    sums its sources' components into a sky-free lambda [B, PIX] (plain
    PyTorch, in chain chunks whose [chunk, C, PIX] intermediates stay near
    32 MB); ``sum_over`` adds the group's partials; sky and the Poisson log
    follow.  Differentiable, with the single-process gradient on every rank.
    """
    from celeste_tpu_torch.kernels.tiled_field import _chain_chunk

    local = _LocalSources(scene, stamp, band, mesh, n_bands)
    px, py, counts, sky, mask = stamp_pixel_data(stamp)

    def loglik(vecs):
        amp, mx, my, pa, pb, pc = local.planes(vecs)
        chunk = _chain_chunk(amp.shape[0], 1, amp.shape[1], px.shape[1])
        parts = []
        for c0, c1 in _chunks(amp.shape[0], chunk):
            dx = px - mx[c0:c1, :, None]                     # [chunk, C, PIX]
            dy = py - my[c0:c1, :, None]
            quad = (pa[c0:c1, :, None] * dx * dx + 2.0 * pb[c0:c1, :, None] * dx * dy
                    + pc[c0:c1, :, None] * dy * dy)
            parts.append(torch.sum(amp[c0:c1, :, None] * torch.exp(-0.5 * quad), dim=1))
        lam = sum_over(torch.cat(parts), mesh, "sources") + sky
        return torch.sum(pixel_loglik(lam, counts, centered) * mask, dim=-1)

    return loglik


def sharded_tiled_crowded_loglik(scene: CrowdedScene, stamp, band, mesh, positions_px,
                                 radii_px=12.0, *, n_bands: int | None = None,
                                 n_buckets: int = 1, chain_chunk: int | None = None,
                                 centered: bool = False):
    """Block-sparse tiling x source sharding x chain sharding:
    ``f(vecs [B, S, D_s]) -> [B]`` on this rank's chains (layout as
    :func:`sharded_crowded_loglik`).

    Each rank renders only its own sources' sky-free lambda tiles through K5
    (one launch per occupancy bucket), ``sum_over`` adds the group's
    partials, and sky and the Poisson log follow on every rank.  The tile
    maps are built on the host from ``positions_px`` [S, 2] and the support
    radii ``radii_px`` (a scalar or [S]), one per shard over the same
    tiling, each padded to the common ``s_max`` with its own sentinel.  The
    occupancy buckets have a structure common to every shard (bucket count,
    tiles per bucket, slot cap): a shard with fewer tiles in a bucket pads
    it with the scratch tile ``T`` (all sentinel, pixel coordinates 0),
    whose zero lambda lands in a row that is dropped.  Each rank keeps only
    its own bucket tables, and builds K6's column lists for them once.

    ``chain_chunk``: chains per pass over the tiles.  The JAX package chunks
    to keep its lambda tiles inside the TPU's 16 MB of VMEM; on the card the
    default lets the [T+1, chunk, PIX] lambda tiles reach 256 MB (config 5,
    seven tiles: ~9,000 chains in one pass).  ``f.buckets`` lists this
    rank's ``TileBucket``s (K5's launches per pass), and ``f.planes(vecs)``
    gives the six planes K5 takes, [B, (S_loc * slots + 1) * C] with the
    sentinel last.
    """
    from celeste_tpu_torch.kernels.tiled_field import TiledStampData, TileBucket, render_bucket
    from celeste_tpu_torch.model.galaxy import N_GAL
    from celeste_tpu_torch.parallel.tiles import PIX_PER_TILE, build_block_tile_map, build_tile_map

    local = _LocalSources(scene, stamp, band, mesh, n_bands)
    n_src, n_shards, s_loc = scene.n_sources, axis_size(mesh, "sources"), local.s_loc
    shape = tuple(stamp.counts.shape)
    pos = np.asarray(positions_px, np.float64)
    if pos.shape != (n_src, 2):
        raise ValueError(f"positions_px must be [{n_src}, 2], got {pos.shape}")
    radii = np.broadcast_to(np.asarray(radii_px, np.float64), (n_src,))
    k_psf = stamp.psf.n_components
    n_comp = k_psf if local.mixed or scene.kinds[0] == "star" else N_GAL * k_psf

    def shard_tm(i):
        sl = slice(i * s_loc, (i + 1) * s_loc)
        if local.mixed:
            return build_block_tile_map(pos[sl], radii[sl], scene.kinds[sl], shape,
                                        n_blocks_gal=N_GAL)
        return build_tile_map(pos[sl], radii[sl], shape)

    tms = [shard_tm(i) for i in range(n_shards)]
    s_max = max(tm.s_max for tm in tms)
    sentinel = s_loc * N_GAL if local.mixed else s_loc
    tables = [np.pad(tm.tile_src, ((0, 0), (0, s_max - tm.s_max)), constant_values=sentinel)
              for tm in tms]
    px, py, counts_t, sky_t, mask_t = TiledStampData(tms[0], stamp).pixels
    n_tiles = tms[0].n_tiles

    # occupancy buckets with a structure common to every shard
    occ = [np.sum(t != sentinel, axis=1) for t in tables]
    if n_buckets > 1 and n_tiles >= 2:
        qs = np.quantile(np.concatenate(occ), np.linspace(0, 1, n_buckets + 1)[1:-1])
        caps = sorted(set(max(1, int(np.ceil(q))) for q in qs) | {s_max})
    else:
        caps = [s_max]
    me = axis_index(mesh, "sources")
    bucket_of = [np.searchsorted(caps, o) for o in occ]
    device = stamp.counts.device
    px_pad = torch.cat([px, torch.zeros_like(px[:1])])
    py_pad = torch.cat([py, torch.zeros_like(py[:1])])
    buckets = []                      # (tile indices [T_b] into T + 1, TileBucket)
    for b, cap in enumerate(caps):
        sel = [np.where(bo == b)[0] for bo in bucket_of]
        t_b = max(len(x) for x in sel)
        if t_b == 0:
            continue
        idx = np.full(t_b, n_tiles, np.int64)                # the scratch tile pads
        tab = np.full((t_b, cap), sentinel, np.int32)
        idx[:len(sel[me])] = sel[me]
        tab[:len(sel[me])] = tables[me][sel[me]][:, :cap]
        idx_t = torch.as_tensor(idx, device=device)
        buckets.append((idx_t, TileBucket(cap, torch.as_tensor(tab, device=device),
                                          (px_pad[idx_t].contiguous(),
                                           py_pad[idx_t].contiguous()))))

    if chain_chunk is None:
        chain_chunk = max(1, (256 << 20) // ((n_tiles + 1) * PIX_PER_TILE * 4))

    def planes_of(vecs):
        planes = local.planes(vecs)
        sentinel_cols = planes[0].new_zeros(planes[0].shape[0], n_comp)
        return tuple(torch.cat([p, sentinel_cols], dim=1) for p in planes)

    def loglik(vecs):
        planes = planes_of(vecs)
        out = []
        for c0, c1 in _chunks(planes[0].shape[0], chain_chunk):
            chunk = tuple(p[c0:c1] for p in planes)
            lam_full = chunk[0].new_zeros(n_tiles + 1, c1 - c0, PIX_PER_TILE)
            for idx, bucket in buckets:
                lam_full = lam_full.index_add(0, idx, render_bucket(chunk, bucket,
                                                                    n_comp=n_comp))
            lam = sum_over(lam_full[:n_tiles], mesh, "sources") + sky_t[:, None, :]
            ll = pixel_loglik(lam, counts_t[:, None, :], centered) * mask_t[:, None, :]
            out.append(torch.sum(ll, dim=(0, 2)))
        return torch.cat(out)

    loglik.buckets = [bucket for _, bucket in buckets]
    loglik.planes = planes_of
    return loglik
