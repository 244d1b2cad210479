"""Block-sparse tiled field log-likelihood and lambda render: the
crowded-field kernels.

Counterpart of ``celeste_tpu/kernels/tiled_field.py``.  The field is cut
into 8x128 = 1024-pixel tiles (``parallel/tiles.py``); a host-built table
``tile_src`` [T, S_MAX] lists the source slots whose support touches each
tile, padded with the sentinel slot.  Every chain carries six
[B, (S+1)*C] precision-form planes, source-major, whose last C columns (the
sentinel) are zero.  The likelihood sums, per tile, S_MAX*C Gaussians
instead of the whole scene's.

Dispatch follows the tensors' device, with no switch and no fallback:

- CUDA tensors launch the hand-written Hopper kernels of
  ``csrc/tiled_field.cu``: K2 (``tiled_fwd_cuda``) for values; under
  autograd, K3 (``tiled_fwd_lam_cuda``, which also keeps lambda) and K4
  (``tiled_bwd_cuda``, the hand backward and its deterministic scatter).
  A build or launch failure raises.  Any tile runs in one launch per
  bucket: one whose components fit a block's shared memory takes the
  whole-tile path, a larger one the staged path (:func:`tile_staged`).
- CPU tensors take the plain PyTorch versions the same way: values through
  :func:`_tiled_torch`; a call that needs a gradient keeps lambda in
  :func:`_tiled_lam_torch` and differentiates with :func:`_tiled_bwd_torch`.

The source-sharded field renders, instead of a log-likelihood, the
sky-free lambda tiles [T, B, PIX] of its own sources (``tiled_field_render``):
K5 (``tiled_render_cuda``) forward and K6 (``tiled_render_bwd_cuda``), which
takes the per-pixel cotangent of lambda, as its gradient on CUDA tensors;
:func:`_tiled_render_torch` and :func:`_tiled_render_bwd_torch` on CPU
tensors.

:func:`_tiled_torch`, :func:`_tiled_lam_torch`, :func:`_tiled_bwd_torch`,
:func:`_tiled_render_torch` and :func:`_tiled_render_bwd_torch` are the plain
versions of K2 to K6: the tests hold them against the JAX package, and
``chip_smoke.py`` holds the kernels against them on the card.  Every plain
version works through the chains in chunks, so that its memory stays bounded
(``_chain_chunk``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from celeste_tpu_torch.likelihood._pixel import LAMBDA_MIN, pixel_loglik
from celeste_tpu_torch.parallel.tiles import (
    PIX_PER_TILE,
    TileMap,
    tile_field_arrays,
    tile_pixel_coords,
)

_SOURCES = ("tiled_field.cu",)
_MAX_CHAINS = 8 * 65535          # grid.y of the tile kernels is chains / 8

# K2-K6's launch (csrc/tiled_field.cu): a block is one tile and TILE_WARPS
# chains, a warp a chain, and each warp stages its chain's K = s_cap * C
# components of the tile in shared memory, 32 bytes each: all of them where
# they fit the block's SMEM_OPTIN bytes, else TILE_CHUNK at a time (the
# staged path, no component cap); the backward pads them to whole passes of
# BWD_ENTRIES.
TILE_WARPS = 8
TILE_CHUNK = 256
BWD_ENTRIES = 8
SMEM_OPTIN = 232448              # the H100's 227 KB a block


# ---------------------------------------------------------------------------
# the field's tiles
# ---------------------------------------------------------------------------

def tile_columns(tile_src, n_comp: int, plane_w: int):
    """Column -> entry list of a tile table, the order K4's scatter sums in:
    ``(col_ptr [plane_w + 1], col_ent [T*S_MAX*C])`` int32 NumPy arrays, where
    the entries of plane column c are the rows ``t*S_MAX*C + s*C + j``
    (ascending) of every (tile t, slot s, component j) that references c."""
    tile_src = np.asarray(tile_src, np.int64)
    cols = (tile_src[:, :, None] * n_comp + np.arange(n_comp)).reshape(-1)
    if cols.size and (cols.min() < 0 or cols.max() >= plane_w):
        raise ValueError(f"tile table references plane columns outside [0, {plane_w})")
    col_ent = np.argsort(cols, kind="stable").astype(np.int32)
    col_ptr = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=plane_w))])
    return col_ptr.astype(np.int32), col_ent


def random_tile_problem(seed: int = 5, b: int = 6, s: int = 4, c: int = 3, t: int = 3):
    """A random problem for checks of the tiled kernels, as float32 NumPy
    arrays (the random-plane setup of the JAX package's tiled-field tests):
    six [b, (s+1)*c] planes whose last slot is the zero sentinel, a random
    int32 [t, s] table with repeated and sentinel slots, five [t, 1024]
    pixel tiles with a holed mask, and an output cotangent g [b]."""
    rng = np.random.default_rng(seed)
    plane_w = (s + 1) * c
    amp = np.abs(rng.normal(1.0, 0.2, (b, plane_w))).astype(np.float32)
    mx = rng.uniform(0, 128, (b, plane_w)).astype(np.float32)
    my = rng.uniform(0, 8 * t, (b, plane_w)).astype(np.float32)
    pa = np.abs(rng.normal(0.5, 0.1, (b, plane_w))).astype(np.float32)
    pc = np.abs(rng.normal(0.5, 0.1, (b, plane_w))).astype(np.float32)
    # |pb| < sqrt(pa pc) / 2: positive-definite precision forms
    pb = np.clip(0.1 * rng.normal(size=(b, plane_w)), -0.5 * np.sqrt(pa * pc),
                 0.5 * np.sqrt(pa * pc)).astype(np.float32)
    for p in (amp, mx, my, pa, pb, pc):
        p[:, -c:] = 0.0
    tile_src = rng.integers(0, s + 1, (t, s)).astype(np.int32)
    ys, xs = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
    px = np.stack([xs.reshape(-1)] * t).astype(np.float32)
    py = np.stack([(ys + 8 * i).reshape(-1) for i in range(t)]).astype(np.float32)
    counts = rng.poisson(5.0, (t, PIX_PER_TILE)).astype(np.float32)
    sky = np.full((t, PIX_PER_TILE), 3.0, np.float32)
    mask = (rng.random((t, PIX_PER_TILE)) > 0.1).astype(np.float32)
    g = rng.normal(size=b).astype(np.float32)
    return (amp, mx, my, pa, pb, pc), tile_src, (px, py, counts, sky, mask), g


def tile_smem_bytes(kernel: str, n_w: int) -> int:
    """Shared memory of a block of ``kernel`` ("fwd": K2 and K3, "render":
    K5, "bwd": K4 and K6) whose warps stage ``n_w`` components each
    (``csrc/tiled_field.cu`` ``fwd_smem_bytes``, ``bwd_smem_bytes``): the
    pixel arrays (six for K2 and K3, px and py for K5; the backward's (px,
    py) pairs and every warp's row of pixel cotangents) and two float4 a
    component and warp."""
    comps = TILE_WARPS * 32
    if kernel == "fwd":
        return 6 * PIX_PER_TILE * 4 + comps * n_w
    if kernel == "render":
        return 2 * PIX_PER_TILE * 4 + comps * n_w
    if kernel == "bwd":
        return (2 + TILE_WARPS) * PIX_PER_TILE * 4 + comps * (-(-n_w // BWD_ENTRIES) * BWD_ENTRIES)
    raise ValueError(kernel)


def tile_staged(kernel: str, n_k: int) -> bool:
    """Whether ``kernel`` ("fwd", "render" or "bwd") takes the staged path
    at ``n_k`` = s_cap * C components a tile: only where the whole tile would
    not fit a block's shared memory (K > 812 for K2 and K3, 876 for K5, 744
    for K4 and K6), so that every tile that fits keeps the whole-tile path.
    The wrappers look it up at each call (the card tests and the smoke
    replace it to hold the two paths bitwise equal where both fit)."""
    return tile_smem_bytes(kernel, n_k) > SMEM_OPTIN


def tile_chunk_walk(kernel: str, n_k: int, staged: bool) -> list[tuple[int, int]]:
    """The chunks ``(k0, n)`` in which a warp of ``kernel`` stages and walks
    a tile's ``n_k`` components, in order (``csrc/tiled_field.cu``, written
    out): the whole tile at once, or TILE_CHUNK at a time; the backward
    stages each chunk with zero entries up to whole passes of BWD_ENTRIES,
    so its ``n`` here is the staged count."""
    pad = BWD_ENTRIES if kernel == "bwd" else 1
    step = TILE_CHUNK if staged else max(n_k, 1)
    return [(k0, -(-min(step, n_k - k0) // pad) * pad) for k0 in range(0, n_k, step)]


class TileBucket:
    """One occupancy bucket's launch: its slot cap, the [T_b, s_cap] table
    and the [T_b, PIX] pixel arrays on the field's device (px, py, counts,
    sky, mask for the log-likelihood; px, py for the render), plus the column
    lists of K4 and K6 (built once per component count, on the host)."""

    def __init__(self, s_cap: int, tile_src, pixels):
        self.s_cap = int(s_cap)
        self.tile_src = tile_src
        self.pixels = pixels
        self._columns = {}

    def columns(self, n_comp: int, plane_w: int):
        key = (n_comp, plane_w)
        if key not in self._columns:
            col_ptr, col_ent = tile_columns(self.tile_src.cpu().numpy(), n_comp, plane_w)
            device = self.tile_src.device
            self._columns[key] = (torch.as_tensor(col_ptr, device=device),
                                  torch.as_tensor(col_ent, device=device))
        return self._columns[key]


class TiledStampData:
    """Tile tables and tiled pixel arrays of one field, on the stamp's device.

    ``tile_src`` [T, S_MAX] int32 and ``pixels`` (px, py, counts, sky, mask)
    as [T, PIX] float32 (padding pixels: mask 0, sky 1).  Occupancy bucketing
    (``n_buckets`` > 1) partitions the tiles by how many sources touch them;
    each bucket gets its own launch with its own slot cap, so sparse tiles
    don't pay the most crowded tile's S_MAX.  ``buckets`` lists
    ``(tile indices, s_cap)`` as the JAX package does; ``bucket_tables`` holds
    each bucket's device tensors.
    """

    def __init__(self, tm: TileMap, stamp, n_buckets: int = 1):
        device = stamp.counts.device
        self.tile_map = tm
        self.tile_src = torch.as_tensor(tm.tile_src, dtype=torch.int32, device=device)
        px, py = tile_pixel_coords(tm)
        counts, sky, mask = tile_field_arrays(
            tm, stamp.counts.cpu().numpy(), stamp.sky.cpu().numpy(), stamp.mask.cpu().numpy(),
            pad_values=(0.0, 1.0, 0.0))
        self.pixels = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                            for a in (px, py, counts, sky, mask))

        occupancy = np.sum(tm.tile_src < tm.n_sources, axis=1)   # [T]
        self.buckets = []
        if n_buckets <= 1 or tm.n_tiles < 2:
            self.buckets.append((np.arange(tm.n_tiles), tm.s_max))
        else:
            # bucket edges at occupancy quantiles; at least width 1
            qs = np.quantile(occupancy, np.linspace(0, 1, n_buckets + 1)[1:-1])
            edges = sorted(set(int(np.ceil(q)) for q in qs))
            lo = 0
            for edge in edges + [tm.s_max]:
                sel = (np.where((occupancy > lo - 1) & (occupancy <= edge))[0]
                       if lo > 0 else np.where(occupancy <= edge)[0])
                if len(sel):
                    self.buckets.append((sel, max(1, int(occupancy[sel].max()))))
                lo = edge + 1
            total = sum(len(s) for s, _ in self.buckets)
            if total != tm.n_tiles:
                raise AssertionError(f"buckets cover {total} of {tm.n_tiles} tiles")
        self.bucket_tables = []
        for sel, s_cap in self.buckets:
            idx = torch.as_tensor(sel, dtype=torch.long, device=device)
            self.bucket_tables.append(TileBucket(
                s_cap, self.tile_src[idx][:, :s_cap].contiguous(),
                tuple(p[idx].contiguous() for p in self.pixels)))


# ---------------------------------------------------------------------------
# plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def _chain_chunk(b: int, s_max: int, n_comp: int, pix: int = PIX_PER_TILE) -> int:
    """Chains per chunk of the plain versions: their [chunk, S_MAX*C, PIX]
    intermediates stay near 32 MB, the bound of the JAX package's
    ``_bwd_chain_chunk``.  (Chunks need not divide B here: PyTorch has no
    static shapes, so the last chunk is simply shorter.)"""
    budget = (1 << 25) // max(1, s_max * n_comp * pix * 4)
    return max(1, min(b, budget))


def _tile_cols(tile_src, n_comp: int):
    """[T, S_MAX] slot table -> [T, S_MAX*C] plane columns."""
    comp = torch.arange(n_comp, device=tile_src.device)
    return (tile_src.long()[:, :, None] * n_comp + comp).reshape(tile_src.shape[0], -1)


def _tile_terms(planes, cols, t_px, t_py):
    """One tile's gathered components against its pixels: (a [B, K],
    (pa, pb, pc) [B, K, 1], dx, dy [B, K, PIX], e [B, K, PIX])."""
    amp, mx, my, pa, pb, pc = (p.index_select(1, cols) for p in planes)
    dx = t_px[None, None, :] - mx[..., None]
    dy = t_py[None, None, :] - my[..., None]
    pa, pb, pc = pa[..., None], pb[..., None], pc[..., None]
    e = torch.exp(-0.5 * (pa * dx * dx + 2.0 * pb * dx * dy + pc * dy * dy))
    return amp, (pa, pb, pc), dx, dy, e


def _tile_lambda(planes, cols, t_px, t_py, t_sky):
    """Pre-clamp lambda [B, PIX] of one tile, sky included."""
    amp, _, _, _, e = _tile_terms(planes, cols, t_px, t_py)
    return t_sky + torch.sum(amp[..., None] * e, dim=1)


def _tiled_torch(planes, tile_src, pixel_tiles, n_comp: int, centered: bool = False):
    """K2's plain version (counterpart of ``_tiled_jnp``): 6 x [B, (S+1)*C]
    planes, a [T, S_MAX] table and 5 x [T, PIX] pixel tiles -> [B], with the
    same tile truncation.  Differentiable by torch autograd."""
    px, py, counts, sky, mask = pixel_tiles
    cols = _tile_cols(tile_src, n_comp)
    b = planes[0].shape[0]
    chunk = _chain_chunk(b, tile_src.shape[1], n_comp)
    out = []
    for c0 in range(0, b, chunk):
        part = [p[c0:c0 + chunk] for p in planes]
        ll = 0.0
        for t in range(tile_src.shape[0]):
            lam = _tile_lambda(part, cols[t], px[t], py[t], sky[t])
            ll = ll + torch.sum(pixel_loglik(lam, counts[t], centered) * mask[t], dim=-1)
        out.append(ll)
    return torch.cat(out)


def _tiled_lam_torch(planes, tile_src, pixel_tiles, n_comp: int, centered: bool = False):
    """K3's plain version: (log-likelihood [B], pre-clamp lambda [T, B, PIX]
    with sky included)."""
    px, py, counts, sky, mask = pixel_tiles
    cols = _tile_cols(tile_src, n_comp)
    b = planes[0].shape[0]
    chunk = _chain_chunk(b, tile_src.shape[1], n_comp)
    lam = torch.stack([
        torch.cat([_tile_lambda([p[c0:c0 + chunk] for p in planes], cols[t], px[t], py[t],
                                sky[t]) for c0 in range(0, b, chunk)])
        for t in range(tile_src.shape[0])])
    ll = torch.sum(pixel_loglik(lam, counts[:, None, :], centered) * mask[:, None, :],
                   dim=(0, 2))
    return ll, lam


def _plane_cotangents(planes, tile_src, px, py, n_comp: int, pixel_cotangent):
    """The cotangents of the six planes [B, (S+1)*C] given each tile's
    per-pixel cotangent of lambda, ``pixel_cotangent(t, c0, c1)`` [c1 - c0,
    PIX] for chains c0:c1: the algebra of
    ``celeste_tpu/kernels/tiled_field.py:116-148``, then a scatter-add of
    every (tile, slot) entry into its plane columns (repeated slots, the
    sentinel above all, accumulate)."""
    cols = _tile_cols(tile_src, n_comp)
    b = planes[0].shape[0]
    chunk = _chain_chunk(b, tile_src.shape[1], n_comp)
    grads = [torch.zeros_like(p) for p in planes]
    for c0 in range(0, b, chunk):
        part = [p[c0:c0 + chunk] for p in planes]
        for t in range(tile_src.shape[0]):
            g_lam = pixel_cotangent(t, c0, c0 + part[0].shape[0])
            amp, (pa, pb, pc), dx, dy, e = _tile_terms(part, cols[t], px[t], py[t])
            ge = g_lam[:, None, :] * e
            dq = -0.5 * ge * amp[..., None]
            terms = (ge.sum(-1),
                     (dq * -2.0 * (pa * dx + pb * dy)).sum(-1),
                     (dq * -2.0 * (pb * dx + pc * dy)).sum(-1),
                     (dq * dx * dx).sum(-1),
                     (2.0 * dq * dx * dy).sum(-1),
                     (dq * dy * dy).sum(-1))
            for grad, term in zip(grads, terms):
                grad[c0:c0 + chunk].index_add_(1, cols[t], term)
    return tuple(grads)


def _tiled_bwd_torch(planes, tile_src, pixel_tiles, lam, g, n_comp: int):
    """K4's plain version: the cotangents of the six planes [B, (S+1)*C]
    given lambda [T, B, PIX] (from K3) and the output cotangent ``g`` [B].
    Independent of ``centered``: centering adds parameter-free terms only."""
    px, py, counts, _, mask = pixel_tiles

    def g_lam(t, c0, c1):
        lam_t = lam[t, c0:c1]
        active = (lam_t > LAMBDA_MIN).to(lam_t.dtype)
        return ((g[c0:c1, None] * mask[t])
                * (counts[t] / torch.clamp(lam_t, min=LAMBDA_MIN) - 1.0) * active)

    return _plane_cotangents(planes, tile_src, px, py, n_comp, g_lam)


def _tiled_render_torch(planes, tile_src, px, py, n_comp: int):
    """K5's plain version (counterpart of ``_tiled_render_jnp``): six
    [B, (S+1)*C] planes, a [T, s_cap] table and [T, PIX] pixel coordinates
    -> the sky-free lambda tiles [T, B, PIX].  Differentiable by torch
    autograd."""
    cols = _tile_cols(tile_src, n_comp)
    b = planes[0].shape[0]
    chunk = _chain_chunk(b, tile_src.shape[1], n_comp)
    return torch.stack([
        torch.cat([_tile_lambda([p[c0:c0 + chunk] for p in planes], cols[t], px[t], py[t], 0.0)
                   for c0 in range(0, b, chunk)])
        for t in range(tile_src.shape[0])])


def _tiled_render_bwd_torch(planes, tile_src, px, py, g, n_comp: int):
    """K6's plain version: the cotangents of the six planes given the
    cotangent ``g`` [T, B, PIX] of :func:`_tiled_render_torch`'s output."""
    return _plane_cotangents(planes, tile_src, px, py, n_comp,
                             lambda t, c0, c1: g[t, c0:c1])


class _PlainTiled(torch.autograd.Function):
    """The CPU path's gradient, built like the card's: the plain K3 keeps
    lambda, and the plain K4 turns it into the plane cotangents."""

    @staticmethod
    def forward(ctx, tile_src, pixel_tiles, n_comp, centered, *planes):
        ll, lam = _tiled_lam_torch(planes, tile_src, pixel_tiles, n_comp, centered)
        ctx.save_for_backward(*planes, lam)
        ctx.tile_src, ctx.pixel_tiles, ctx.n_comp = tile_src, pixel_tiles, n_comp
        return ll

    @staticmethod
    def backward(ctx, g):
        *planes, lam = ctx.saved_tensors
        grads = _tiled_bwd_torch(planes, ctx.tile_src, ctx.pixel_tiles, lam, g, ctx.n_comp)
        return (None, None, None, None) + grads


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes wrappers
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tiled_field_fwd.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.tiled_field_fwd.restype = i
    lib.tiled_field_bwd.argtypes = [p] * 17 + [i] * 6 + [p]
    lib.tiled_field_bwd.restype = i
    lib.tiled_field_render.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.tiled_field_render.restype = i
    lib.tiled_field_render_bwd.argtypes = [p] * 14 + [i] * 6 + [p]
    lib.tiled_field_render_bwd.restype = i
    lib.tiled_field_error_string.argtypes = [i]
    lib.tiled_field_error_string.restype = ctypes.c_char_p


def _lib():
    from celeste_tpu_torch.kernels._build import load_library

    return load_library("tiled_field", _SOURCES, _declare)


def build_kernels():
    """Build and load the CUDA library now (it is otherwise built at the
    first launch).  Returns the path of the shared library."""
    return Path(_lib()._name)


def _check(t, shape, dtype, device, name):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_inputs(planes, tile_src, pixel_tiles, n_comp):
    """Raise unless the planes are six contiguous float32 [B, (S+1)*C] CUDA
    tensors, ``tile_src`` a contiguous int32 [T, s_cap] table and the pixels
    float32 [T, PIX] tiles (five, or px and py for the render), all on one
    device.  The table's entries are
    not read here (that would synchronise): ``TiledStampData`` builds them in
    range, and ``tile_columns`` checks a table it is given."""
    amp = planes[0]
    if amp.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {amp.device}")
    if amp.dim() != 2 or amp.shape[1] % n_comp:
        raise ValueError(f"planes must be [B, (S+1)*{n_comp}], got {tuple(amp.shape)}")
    b, plane_w = amp.shape
    if b > _MAX_CHAINS:
        raise ValueError(f"{b} chains exceed the tile kernels' limit of {_MAX_CHAINS}")
    device = amp.device
    for t in planes:
        _check(t, (b, plane_w), torch.float32, device, "plane")
    if tile_src.dim() != 2:
        raise ValueError(f"tile_src must be [T, s_cap], got {tuple(tile_src.shape)}")
    _check(tile_src, tile_src.shape, torch.int32, device, "tile_src")
    n_tiles, s_cap = tile_src.shape
    for t in pixel_tiles:
        _check(t, (n_tiles, PIX_PER_TILE), torch.float32, device, "pixel tile")
    return b, plane_w, n_tiles, s_cap, device


def _raise_on_error(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.tiled_field_error_string(err).decode()} ({err})")


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _launch_fwd(planes, tile_src, pixel_tiles, n_comp, centered, keep_lam):
    b, plane_w, n_tiles, s_cap, device = _check_inputs(planes, tile_src, pixel_tiles, n_comp)
    partial = torch.empty(n_tiles, b, dtype=torch.float32, device=device)
    lam = (torch.empty(n_tiles, b, PIX_PER_TILE, dtype=torch.float32, device=device)
           if keep_lam else None)
    if b and n_tiles:
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.tiled_field_fwd(*_ptrs(planes), tile_src.data_ptr(), *_ptrs(pixel_tiles),
                                      partial.data_ptr(), lam.data_ptr() if keep_lam else None,
                                      n_tiles, b, plane_w, s_cap, n_comp, int(bool(centered)),
                                      int(tile_staged("fwd", s_cap * n_comp)), stream)
        _raise_on_error(lib, err, "tiled_field_fwd")
    return partial.sum(0), lam


def tiled_fwd_cuda(amp, mx, my, pa, pb, pc, tile_src, px, py, counts, sky, mask, *,
                   n_comp: int, centered: bool = False):
    """Launch K2: the tiled log-likelihood [B] of one bucket's tiles."""
    out, _ = _launch_fwd((amp, mx, my, pa, pb, pc), tile_src, (px, py, counts, sky, mask),
                         n_comp, centered, keep_lam=False)
    tiled_fwd_cuda.launches += 1
    return out


tiled_fwd_cuda.launches = 0


def tiled_fwd_lam_cuda(amp, mx, my, pa, pb, pc, tile_src, px, py, counts, sky, mask, *,
                       n_comp: int, centered: bool = False):
    """Launch K3: (log-likelihood [B], pre-clamp lambda [T, B, PIX])."""
    out = _launch_fwd((amp, mx, my, pa, pb, pc), tile_src, (px, py, counts, sky, mask),
                      n_comp, centered, keep_lam=True)
    tiled_fwd_lam_cuda.launches += 1
    return out


tiled_fwd_lam_cuda.launches = 0


def tiled_bwd_cuda(amp, mx, my, pa, pb, pc, tile_src, px, py, counts, sky, mask, lam, g,
                   col_ptr, col_ent, *, n_comp: int):
    """Launch K4: the six plane cotangents [B, (S+1)*C] from K3's lambda and
    the output cotangent ``g`` [B]; ``(col_ptr, col_ent)`` from
    :func:`tile_columns` of the same table, as int32 tensors on the card."""
    planes = (amp, mx, my, pa, pb, pc)
    pixel_tiles = (px, py, counts, sky, mask)
    b, plane_w, n_tiles, s_cap, device = _check_inputs(planes, tile_src, pixel_tiles, n_comp)
    _check(lam, (n_tiles, b, PIX_PER_TILE), torch.float32, device, "lam")
    _check(g, (b,), torch.float32, device, "g")
    _check(col_ptr, (plane_w + 1,), torch.int32, device, "col_ptr")
    _check(col_ent, (n_tiles * s_cap * n_comp,), torch.int32, device, "col_ent")
    d_planes = torch.empty(6, b, plane_w, dtype=torch.float32, device=device)
    if b:
        d_part = torch.empty(6, n_tiles * s_cap * n_comp, b, dtype=torch.float32,
                             device=device)
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.tiled_field_bwd(*_ptrs(planes), tile_src.data_ptr(), px.data_ptr(),
                                      py.data_ptr(), counts.data_ptr(), mask.data_ptr(),
                                      lam.data_ptr(), g.data_ptr(), col_ptr.data_ptr(),
                                      col_ent.data_ptr(), d_part.data_ptr(),
                                      d_planes.data_ptr(), n_tiles, b, plane_w, s_cap, n_comp,
                                      int(tile_staged("bwd", s_cap * n_comp)), stream)
        _raise_on_error(lib, err, "tiled_field_bwd")
    tiled_bwd_cuda.launches += 1
    return tuple(d_planes.unbind(0))


tiled_bwd_cuda.launches = 0


def tiled_render_cuda(amp, mx, my, pa, pb, pc, tile_src, px, py, *, n_comp: int):
    """Launch K5: the sky-free lambda tiles [T, B, PIX] of one table."""
    planes = (amp, mx, my, pa, pb, pc)
    b, plane_w, n_tiles, s_cap, device = _check_inputs(planes, tile_src, (px, py), n_comp)
    lam = torch.empty(n_tiles, b, PIX_PER_TILE, dtype=torch.float32, device=device)
    if b and n_tiles:
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.tiled_field_render(*_ptrs(planes), tile_src.data_ptr(), px.data_ptr(),
                                         py.data_ptr(), lam.data_ptr(), n_tiles, b, plane_w,
                                         s_cap, n_comp, int(tile_staged("render", s_cap * n_comp)),
                                         stream)
        _raise_on_error(lib, err, "tiled_field_render")
    tiled_render_cuda.launches += 1
    return lam


tiled_render_cuda.launches = 0


def tiled_render_bwd_cuda(amp, mx, my, pa, pb, pc, tile_src, px, py, g, col_ptr, col_ent, *,
                          n_comp: int):
    """Launch K6: the six plane cotangents [B, (S+1)*C] from the cotangent
    ``g`` [T, B, PIX] of K5's output; ``(col_ptr, col_ent)`` from
    :func:`tile_columns` of the same table, as int32 tensors on the card."""
    planes = (amp, mx, my, pa, pb, pc)
    b, plane_w, n_tiles, s_cap, device = _check_inputs(planes, tile_src, (px, py), n_comp)
    _check(g, (n_tiles, b, PIX_PER_TILE), torch.float32, device, "g")
    _check(col_ptr, (plane_w + 1,), torch.int32, device, "col_ptr")
    _check(col_ent, (n_tiles * s_cap * n_comp,), torch.int32, device, "col_ent")
    d_planes = torch.empty(6, b, plane_w, dtype=torch.float32, device=device)
    if b:
        d_part = torch.empty(6, n_tiles * s_cap * n_comp, b, dtype=torch.float32,
                             device=device)
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.tiled_field_render_bwd(*_ptrs(planes), tile_src.data_ptr(), px.data_ptr(),
                                             py.data_ptr(), g.data_ptr(), col_ptr.data_ptr(),
                                             col_ent.data_ptr(), d_part.data_ptr(),
                                             d_planes.data_ptr(), n_tiles, b, plane_w, s_cap,
                                             n_comp, int(tile_staged("bwd", s_cap * n_comp)),
                                             stream)
        _raise_on_error(lib, err, "tiled_field_render_bwd")
    tiled_render_bwd_cuda.launches += 1
    return tuple(d_planes.unbind(0))


tiled_render_bwd_cuda.launches = 0

_WRAPPERS = {"tiled_field_fwd": tiled_fwd_cuda, "tiled_field_fwd_lam": tiled_fwd_lam_cuda,
             "tiled_field_bwd": tiled_bwd_cuda, "tiled_field_render": tiled_render_cuda,
             "tiled_field_render_bwd": tiled_render_bwd_cuda}


def reset_launch_counts():
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0


def launch_counts():
    return {name: wrapper.launches for name, wrapper in _WRAPPERS.items()}


class _TiledKernel(torch.autograd.Function):
    """K3 forward, keeping lambda, with K4 as its gradient."""

    @staticmethod
    def forward(ctx, bucket, n_comp, centered, *planes):
        ll, lam = tiled_fwd_lam_cuda(*planes, bucket.tile_src, *bucket.pixels,
                                     n_comp=n_comp, centered=centered)
        ctx.save_for_backward(*planes, lam)
        ctx.bucket, ctx.n_comp = bucket, n_comp
        return ll

    @staticmethod
    def backward(ctx, g):
        *planes, lam = ctx.saved_tensors
        bucket = ctx.bucket
        col_ptr, col_ent = bucket.columns(ctx.n_comp, planes[0].shape[1])
        grads = tiled_bwd_cuda(*planes, bucket.tile_src, *bucket.pixels, lam, g.contiguous(),
                               col_ptr, col_ent, n_comp=ctx.n_comp)
        return (None, None, None) + grads


class _TiledRender(torch.autograd.Function):
    """The sky-free lambda render of one bucket, by device: K5 forward and K6
    backward on CUDA tensors, the plain pair on CPU tensors.  K6 needs no
    residual but the planes."""

    @staticmethod
    def forward(ctx, bucket, n_comp, *planes):
        px, py = bucket.pixels[:2]
        if planes[0].device.type == "cuda":
            lam = tiled_render_cuda(*planes, bucket.tile_src, px, py, n_comp=n_comp)
        else:
            lam = _tiled_render_torch(planes, bucket.tile_src, px, py, n_comp)
        ctx.save_for_backward(*planes)
        ctx.bucket, ctx.n_comp = bucket, n_comp
        return lam

    @staticmethod
    def backward(ctx, g):
        planes = ctx.saved_tensors
        bucket, n_comp = ctx.bucket, ctx.n_comp
        px, py = bucket.pixels[:2]
        if planes[0].device.type == "cuda":
            cols = bucket.columns(n_comp, planes[0].shape[1])
            grads = tiled_render_bwd_cuda(*planes, bucket.tile_src, px, py, g.contiguous(),
                                          *cols, n_comp=n_comp)
        else:
            grads = _tiled_render_bwd_torch(planes, bucket.tile_src, px, py, g, n_comp)
        return (None, None) + tuple(grads)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _device_of(planes, name):
    device = planes[0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} has no implementation on {device}")
    return device

def tiled_field_loglik(planes, data: TiledStampData, *, n_comp: int, centered: bool = False):
    """Poisson log-likelihood [B] of a batched multi-source field, block-sparse.

    ``planes``: six [B, (S+1)*C] float32 planes in precision form
    (source-major; the final C columns are the zero sentinel slot).  One
    launch per occupancy bucket.  On CUDA tensors a call that needs a
    gradient (grad mode on and a plane that requires it) runs K3 and keeps
    lambda for K4; any other call runs K2.  Differentiable on both devices.
    """
    planes = tuple(planes)
    device = _device_of(planes, "tiled_field_loglik")
    out = 0.0
    need_grad = torch.is_grad_enabled() and any(p.requires_grad for p in planes)
    for bucket in data.bucket_tables:
        if device.type == "cpu":
            if need_grad:
                ll = _PlainTiled.apply(bucket.tile_src, bucket.pixels, n_comp, bool(centered),
                                       *planes)
            else:
                ll = _tiled_torch(planes, bucket.tile_src, bucket.pixels, n_comp, centered)
        else:
            ps = tuple(p.contiguous() for p in planes)
            if need_grad:
                ll = _TiledKernel.apply(bucket, n_comp, bool(centered), *ps)
            else:
                ll = tiled_fwd_cuda(*ps, bucket.tile_src, *bucket.pixels, n_comp=n_comp,
                                    centered=centered)
        out = out + ll
    return out


def tiled_field_loglik_plain(planes, data: TiledStampData, *, n_comp: int,
                             centered: bool = False):
    """:func:`tiled_field_loglik` through the plain versions on any device
    (differentiable): what ``chip_smoke.py`` and ``chip_profile.py`` time the
    kernels against."""
    out = 0.0
    for bucket in data.bucket_tables:
        out = out + _PlainTiled.apply(bucket.tile_src, bucket.pixels, n_comp, bool(centered),
                                      *planes)
    return out


def render_bucket(planes, bucket: TileBucket, *, n_comp: int):
    """Sky-free lambda tiles [T_b, B, PIX] of one bucket's table (K5 on CUDA
    tensors, the plain version on CPU tensors); differentiable, with K6 or
    the plain backward as the gradient.  ``bucket.pixels`` starts with the
    tiles' px and py."""
    planes = tuple(p.contiguous() for p in planes)
    _device_of(planes, "tiled_field_render")
    return _TiledRender.apply(bucket, n_comp, *planes)


def tiled_field_render(planes, data: TiledStampData, *, n_comp: int):
    """Sky-free lambda tiles [T, B, PIX] of a batched multi-source field
    over its whole table: the building block of the source-sharded field,
    whose shards render their own sources' partials, sum them over the
    shards, then add sky and take the log-likelihood
    (``parallel.crowded.sharded_tiled_crowded_loglik``)."""
    return tiled_field_render_explicit(planes, data.tile_src, *data.pixels[:2], n_comp=n_comp,
                                       s_max=data.tile_map.s_max)


def tiled_field_render_explicit(planes, tile_src, px, py, *, n_comp: int, s_max: int):
    """:func:`tiled_field_render` with the table [T, s_max] and the pixel
    coordinates [T, PIX] passed explicitly (a shard's own table, or one
    bucket of it).  K6's column lists are built from the table on the host
    at the first backward."""
    if tuple(tile_src.shape[1:]) != (s_max,):
        raise ValueError(f"tile_src {tuple(tile_src.shape)} is not [T, s_max={s_max}]")
    return render_bucket(planes, TileBucket(s_max, tile_src, (px, py)), n_comp=n_comp)


# ---------------------------------------------------------------------------
# model integration: joint scene vectors -> padded planes
# ---------------------------------------------------------------------------

def scene_planes_padded(scene, vecs, stamp, band):
    """[B, D_total] joint vectors of a uniform-kind scene -> six source-major
    planes [B, (S+1)*C], the sentinel slot last."""
    from celeste_tpu_torch.kernels.mog_field import _field_planes

    if len(set(scene.kinds)) != 1:
        raise ValueError("scene_planes_padded needs a scene of one source kind")
    kind = scene.kinds[0]
    blocks, _ = scene.block_slices()
    per_src = [_field_planes(vecs[:, off:off + d], stamp, band, kind, scene.n_bands)
               for off, d, _ in blocks]
    out = []
    for parts in zip(*per_src):
        out.append(torch.cat(list(parts) + [torch.zeros_like(parts[0])], dim=1))
    return tuple(out)


def scene_planes_blocked(scene, vecs, stamp, band):
    """[B, D_total] joint vectors of a mixed-kind scene -> six block-slot
    planes [B, (S*N_GAL + 1)*K] for the tiled kernels with ``n_comp = K``.

    Source i owns slots i*N_GAL .. (i+1)*N_GAL - 1, each K (PSF components)
    wide; a star fills slot i*N_GAL and leaves the rest zero (the block tile
    map never lists them).  The sentinel slot comes last.
    """
    from celeste_tpu_torch.kernels.mog_field import _field_planes
    from celeste_tpu_torch.model.galaxy import N_GAL

    k = stamp.psf.n_components
    blocks, _ = scene.block_slices()
    per_src = []
    for off, d, kind in blocks:
        p = _field_planes(vecs[:, off:off + d], stamp, band, kind, scene.n_bands)
        if kind == "star":
            p = tuple(torch.cat([x, x.new_zeros(x.shape[0], (N_GAL - 1) * k)], dim=1)
                      for x in p)
        per_src.append(p)
    out = []
    for parts in zip(*per_src):
        out.append(torch.cat(list(parts) + [parts[0].new_zeros(parts[0].shape[0], k)], dim=1))
    return tuple(out)
