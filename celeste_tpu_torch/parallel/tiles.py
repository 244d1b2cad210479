"""Block-sparse source->tile mapping for large-field rendering.

A NumPy copy of ``celeste_tpu/parallel/tiles.py``, kept line for line so
that both packages build identical tile tables (and truncate identically)
from the same positions and radii.  Host-side, built once per scene
layout: every 8x128 field tile gets the (padded) list of sources whose
support radius touches it.  The tiled kernels
(``celeste_tpu_torch/csrc/tiled_field.cu``) then do S_MAX work per tile
instead of S work; the win for crowded fields is S / S_MAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

TILE_H = 8
TILE_W = 128
PIX_PER_TILE = TILE_H * TILE_W


@dataclass
class TileMap:
    """Static tiling of an (H, W) field.

    tile_src : [T, s_max] int32 — source indices per tile; entries == S
        (one past the last real source) select the zero-amplitude padding
        slot in the parameter planes.
    n_dropped : sources-per-tile overflow count (0 in a healthy layout;
        logged by build_tile_map when truncation happens — no silent caps).
    """

    h: int
    w: int
    h_pad: int
    w_pad: int
    n_ty: int
    n_tx: int
    s_max: int
    n_sources: int
    tile_src: np.ndarray
    n_dropped: int

    @property
    def n_tiles(self):
        return self.n_ty * self.n_tx


def build_tile_map(positions_px, radii_px, shape, s_max: int | None = None) -> TileMap:
    """positions_px [S, 2] (x, y) source centers; radii_px [S] support
    radii (e.g. 4 sigma of the widest component); shape = (H, W)."""
    h, w = shape
    n_ty = math.ceil(h / TILE_H)
    n_tx = math.ceil(w / TILE_W)
    pos = np.asarray(positions_px, np.float64).reshape(-1, 2)
    rad = np.broadcast_to(np.asarray(radii_px, np.float64), (pos.shape[0],))
    s = pos.shape[0]

    per_tile: list[list[int]] = [[] for _ in range(n_ty * n_tx)]
    for i in range(s):
        if rad[i] < 0:
            continue  # dropped entry (zero-amplitude block): touches nothing
        x0 = max(0, int((pos[i, 0] - rad[i]) // TILE_W))
        x1 = min(n_tx - 1, int((pos[i, 0] + rad[i]) // TILE_W))
        y0 = max(0, int((pos[i, 1] - rad[i]) // TILE_H))
        y1 = min(n_ty - 1, int((pos[i, 1] + rad[i]) // TILE_H))
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                per_tile[ty * n_tx + tx].append(i)

    max_seen = max((len(t) for t in per_tile), default=0)
    if s_max is None:
        s_max = max(1, max_seen)
    n_dropped = 0
    tile_src = np.full((n_ty * n_tx, s_max), s, np.int32)  # sentinel = padding slot
    for t, lst in enumerate(per_tile):
        if len(lst) > s_max:
            # keep the closest sources to the tile center (no silent bias
            # toward array order); count the drop loudly
            cx = (t % n_tx) * TILE_W + TILE_W / 2
            cy = (t // n_tx) * TILE_H + TILE_H / 2
            lst = sorted(lst, key=lambda i: (pos[i, 0] - cx) ** 2 + (pos[i, 1] - cy) ** 2)
            n_dropped += len(lst) - s_max
            lst = lst[:s_max]
        tile_src[t, : len(lst)] = lst
    if n_dropped:
        import logging

        logging.getLogger(__name__).warning(
            "tile map truncated %d source-tile pairs (s_max=%d, max_seen=%d); "
            "raise s_max for exact rendering", n_dropped, s_max, max_seen)
    return TileMap(h=h, w=w, h_pad=n_ty * TILE_H, w_pad=n_tx * TILE_W,
                   n_ty=n_ty, n_tx=n_tx, s_max=s_max, n_sources=s,
                   tile_src=tile_src, n_dropped=n_dropped)


def build_block_tile_map(positions_px, radii_px, kinds, shape,
                         n_blocks_gal: int, s_max: int | None = None) -> TileMap:
    """Component-BLOCK tile map for mixed star/galaxy scenes.

    The tiled kernels treat the parameter planes as uniform slots of width
    K (the PSF component count).  A galaxy has N_GAL * K components =
    ``n_blocks_gal`` blocks; a star has K = 1 block.  To keep the plane
    layout rectangular (and SPMD across source shards), EVERY source owns
    ``n_blocks_gal`` slot ids — source i's block j is slot
    ``i * n_blocks_gal + j`` — but only its REAL blocks ever appear in a
    tile list, so per-tile work tracks the true component count (stars
    don't pay the galaxy width in the hot loop).  The sentinel/padding slot
    is ``S * n_blocks_gal``; unused star slots hold zero-amplitude planes
    and are simply never referenced.
    """
    pos = np.asarray(positions_px, np.float64).reshape(-1, 2)
    s = pos.shape[0]
    assert len(kinds) == s, (len(kinds), s)
    # radii: scalar / [S] (uniform over a source's blocks) or
    # [S, n_blocks_gal] per-block (model.galaxy.block_support_radii — each
    # component block truncated at its own scale+amplitude; entries < 0
    # drop the block from every tile)
    rad_arr = np.asarray(radii_px, np.float64)
    per_block = rad_arr.ndim == 2
    if per_block:
        assert rad_arr.shape == (s, n_blocks_gal), (rad_arr.shape, s, n_blocks_gal)
    else:
        rad_arr = np.broadcast_to(rad_arr, (s,))
    slot_ids, block_pos, block_rad = [], [], []
    for i, kind in enumerate(kinds):
        nb = 1 if kind == "star" else n_blocks_gal
        for j in range(nb):
            slot_ids.append(i * n_blocks_gal + j)
            block_pos.append(pos[i])
            block_rad.append(rad_arr[i, j] if per_block else rad_arr[i])
    tm = build_tile_map(np.asarray(block_pos), np.asarray(block_rad), shape,
                        s_max=s_max)
    # remap local real-block indices -> global slot ids (sentinel last)
    lut = np.asarray(slot_ids + [s * n_blocks_gal], np.int32)
    tile_src = lut[tm.tile_src]
    return TileMap(h=tm.h, w=tm.w, h_pad=tm.h_pad, w_pad=tm.w_pad,
                   n_ty=tm.n_ty, n_tx=tm.n_tx, s_max=tm.s_max,
                   n_sources=s * n_blocks_gal, tile_src=tile_src,
                   n_dropped=tm.n_dropped)


def tile_field_arrays(tm: TileMap, *arrays, pad_values):
    """Reshape [H, W] field arrays into [T, PIX_PER_TILE] tile-major order.
    ``pad_values`` gives the fill value per array (sky pads with 1.0 to
    keep logs finite, masks with 0)."""
    out = []
    for arr, fill in zip(arrays, pad_values):
        a = np.asarray(arr)
        padded = np.full((tm.h_pad, tm.w_pad), fill, a.dtype)
        padded[: tm.h, : tm.w] = a
        t = padded.reshape(tm.n_ty, TILE_H, tm.n_tx, TILE_W)
        t = t.transpose(0, 2, 1, 3).reshape(tm.n_tiles, PIX_PER_TILE)
        out.append(t)
    return out


def tile_pixel_coords(tm: TileMap):
    """Pixel-center (x, y) coordinates in the same [T, PIX_PER_TILE]
    order.  Built directly at padded size (routing through
    tile_field_arrays would double-pad and break on non-tile-aligned
    fields)."""
    yy, xx = np.mgrid[0: tm.h_pad, 0: tm.w_pad].astype(np.float32)

    def t(a):
        return (a.reshape(tm.n_ty, TILE_H, tm.n_tx, TILE_W)
                .transpose(0, 2, 1, 3).reshape(tm.n_tiles, PIX_PER_TILE))

    return [t(xx), t(yy)]
