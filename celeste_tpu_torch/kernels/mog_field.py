"""Fused MoG-field render + Poisson log-likelihood: the stamp kernel.

Counterpart of ``celeste_tpu/kernels/mog_field.py``.  Chains are the batch
axis B; each chain carries C Gaussian components in precision form as six
[B, C] float32 planes (amplitude with every normaliser folded in, centre,
inverse-covariance entries).  Pixels come as five lane-padded [1, PIX_PAD]
arrays from :func:`stamp_pixel_data`; padded pixels have mask 0 and sky 1.
:func:`mog_field_loglik` returns one log-likelihood per chain, [B];
:func:`mog_field_render` returns the expected-count images, [B, PIX_PAD].

Pixel sets.  The five arrays may also be [S, PIX_PAD], one set per cutout
or fit group (:func:`pad_pixel_sets`): the B rows split into S runs of
R = B / S contiguous rows, and row b reads set b // R.  The stamp's [1, P]
call is the case S = 1.

Dispatch follows the tensors' device, with no switch and no fallback:

- CUDA tensors launch the hand-written Hopper kernels of
  ``csrc/mog_field.cu`` (K1: ``mog_field_loglik_fwd`` forward and, under
  autograd, ``mog_field_loglik_bwd`` backward; K7: ``mog_field_render``).
  A build or launch failure raises.
- CPU tensors take the plain PyTorch versions, :func:`_loglik_torch` (whose
  gradient is torch autograd) and :func:`_render_torch`.

:func:`_loglik_torch`, :func:`_loglik_bwd_torch` and :func:`_render_torch`
are the kernels' plain versions: the tests hold them against the JAX
package, and ``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from celeste_tpu_torch.kernels._build import Library, check_tensor, cuda_device, ptrs
from celeste_tpu_torch.likelihood._pixel import LAMBDA_MIN, pixel_loglik

LANE = 128

# K1's launch geometry (csrc/mog_field.cu): a block is WARPS warps, split
# between CB chains and WARPS / CB warps per chain; a cluster of T <= 8
# blocks splits the same chains' pixels; pixels go in groups of 32, a pixel
# per lane, staged CHUNK_GROUPS groups at a time.
WARPS = 8
MAX_CLUSTER = 8
N_SM = 132                  # the H100's streaming multiprocessors
CHUNK_GROUPS = 32
# A row's components are staged in shared memory whole where they fit the
# SMEM_OPTIN bytes a block may take (the H100's 227 KB), else 96 at a time
# (csrc/mog_field.cu: the staged path, no component cap)
SMEM_OPTIN = 232448
BWD_ENTRIES = 8             # the general backward's components per moment pass


def stamp_pixel_data(stamp):
    """Flatten a Stamp's pixel grids into kernel-ready padded [1, PIX_PAD]
    tensors (px, py, counts, sky, mask); PIX_PAD is H*W rounded up to 128."""
    px, py = stamp.pixel_grid()
    counts = stamp.counts.reshape(-1)
    sky = stamp.sky.reshape(-1)
    mask = stamp.mask.reshape(-1)
    pix = px.shape[0]
    pad = ((pix + LANE - 1) // LANE) * LANE - pix
    px = F.pad(px, (0, pad))[None, :]
    py = F.pad(py, (0, pad))[None, :]
    counts = F.pad(counts, (0, pad))[None, :]
    sky = F.pad(sky, (0, pad), value=1.0)[None, :]   # keep log() finite
    mask = F.pad(mask, (0, pad))[None, :]
    return px, py, counts, sky, mask


def pad_pixel_sets(px, py, counts, sky, mask):
    """Per-set pixel arrays [S, P] (tensors) -> the kernels' lane-padded
    [S, PIX_PAD] float32 sets, PIX_PAD = P rounded up to 128; the padding
    has x = y = 0, counts 0, sky 1 and mask 0, as :func:`stamp_pixel_data`
    pads a stamp, so it adds exactly 0 to every log-likelihood, centered or
    not, and renders as the sky."""
    pad = -px.shape[-1] % LANE
    return tuple(F.pad(t.to(torch.float32), (0, pad), value=v).contiguous()
                 for t, v in ((px, 0.0), (py, 0.0), (counts, 0.0), (sky, 1.0), (mask, 0.0)))


def rows_of_sets(pixels, n_rows: int):
    """The plain versions' view of [S, P] pixel sets for ``n_rows`` rows:
    each set repeated for its R = n_rows / S contiguous rows ([B, P]); one
    set stays [1, P] and broadcasts."""
    s = pixels[0].shape[0]
    if s == 1:
        return pixels
    if n_rows % s:
        raise ValueError(f"{n_rows} rows do not split into {s} pixel sets")
    return tuple(t.repeat_interleave(n_rows // s, dim=0) for t in pixels)


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------

def _loglik_torch(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask,
                  centered: bool = False):
    """Identical math to the forward kernel, dense: [B, C] planes, [1, P]
    pixels -> [B] log-likelihoods."""
    dx = px[:, None, :] - mx[..., None]          # [B, C, P]
    dy = py[:, None, :] - my[..., None]
    quad = pa[..., None] * dx * dx + 2.0 * pb[..., None] * dx * dy + pc[..., None] * dy * dy
    lam = sky + torch.sum(amp[..., None] * torch.exp(-0.5 * quad), dim=1)
    ll = pixel_loglik(lam, counts, centered) * mask
    return torch.sum(ll, dim=-1)


def _render_torch(amp, mx, my, pa, pb, pc, px, py, sky):
    """The render kernel's math, dense: [B, C] planes, [1, P] pixels (or
    [B, P], a pixel set per row) -> lambda [B, P], padded pixels included.
    Chains go in chunks that keep each [chunk, C, P] intermediate near 128
    MB (a 48x128 field of 126 components at B=1024 is 3 GB per intermediate
    unchunked)."""
    chunk = max(1, 2**25 // (amp.shape[1] * px.shape[1]))
    out = []
    for c0 in range(0, amp.shape[0], chunk):
        a, x0, y0, qa, qb, qc = (t[c0:c0 + chunk, :, None] for t in (amp, mx, my, pa, pb, pc))
        rows = slice(c0, c0 + chunk) if px.shape[0] > 1 else slice(None)
        dx = px[rows, None, :] - x0              # [chunk, C, P]
        dy = py[rows, None, :] - y0
        quad = qa * dx * dx + 2.0 * qb * dx * dy + qc * dy * dy
        out.append(sky[rows] + torch.sum(a * torch.exp(-0.5 * quad), dim=1))
    return torch.cat(out) if out else sky.new_empty(0, sky.shape[1])


def random_render_problem(b: int, c: int, h: int, w: int, seed: int = 0):
    """A random render problem as float32 NumPy arrays, for checks of K7
    away from a source model: planes (amp, mx, my, pa, pb, pc) [b, c] of c
    rotated Gaussians (widths 0.5-6 pixels) spread over an h x w stamp, with
    every 9th chain at zero amplitude (it must render exactly the sky); and
    the stamp's lane-padded pixel arrays px, py, sky [1, PIX_PAD] as
    :func:`stamp_pixel_data` lays them out (padding x = y = 0, sky = 1)."""
    rng = np.random.default_rng(seed)
    sig = rng.uniform(0.5, 6.0, (2, b, c))
    th = rng.uniform(0.0, np.pi, (b, c))
    cs, sn = np.cos(th), np.sin(th)
    # the precision R diag(1 / sig^2) R^T of the covariance R diag(sig^2) R^T
    ix, iy = sig[0] ** -2, sig[1] ** -2
    pa, pb, pc = cs * cs * ix + sn * sn * iy, cs * sn * (ix - iy), sn * sn * ix + cs * cs * iy
    flux = rng.uniform(2e3, 2e4, (b, 1)) * rng.dirichlet(np.ones(c), b)
    amp = flux / (2 * np.pi * sig[0] * sig[1])
    amp[::9] = 0.0
    mx = rng.uniform(0.0, w - 1.0, (1, c)) + rng.normal(0.0, 0.5, (b, c))
    my = rng.uniform(0.0, h - 1.0, (1, c)) + rng.normal(0.0, 0.5, (b, c))
    pix = h * w
    pad = -(-pix // LANE) * LANE
    px, py, sky = np.zeros((1, pad)), np.zeros((1, pad)), np.ones((1, pad))
    px[0, :pix] = np.tile(np.arange(w), h)
    py[0, :pix] = np.repeat(np.arange(h), w)
    sky[0, :pix] = rng.uniform(90.0, 110.0, pix)
    f32 = [np.ascontiguousarray(a, dtype=np.float32) for a in (amp, mx, my, pa, pb, pc, px, py,
                                                               sky)]
    return tuple(f32[:6]), tuple(f32[6:])


def random_pixel_set_problem(n_sets: int, rows_per_set: int, c: int, side: int, seed: int = 0):
    """A random pixel-set problem as float32 NumPy arrays, for checks of the
    pixel-set mode away from the field pipeline: planes (amp, mx, my, pa,
    pb, pc) [S R, C] of C rotated Gaussians per row around its own set's
    cutout (widths 0.5-4 pixels, every 9th row at zero amplitude), and S
    cutouts of side x side pixels at different global origins, lane-padded
    as :func:`pad_pixel_sets` lays them out: px, py, counts (Poisson draws
    of each set's first row's lambda), sky (90-110 counts; 1 on the
    padding) and mask (a few pixels masked; 0 on the padding), each
    [S, PIX_PAD]."""
    rng = np.random.default_rng(seed)
    b = n_sets * rows_per_set
    origins = rng.integers(0, 2000, (n_sets, 2)).astype(np.float64)
    oxy = np.repeat(origins, rows_per_set, axis=0)                      # [B, 2]
    sig = rng.uniform(0.5, 4.0, (2, b, c))
    th = rng.uniform(0.0, np.pi, (b, c))
    cs, sn = np.cos(th), np.sin(th)
    ix, iy = sig[0] ** -2, sig[1] ** -2
    pa, pb, pc = cs * cs * ix + sn * sn * iy, cs * sn * (ix - iy), sn * sn * ix + cs * cs * iy
    flux = rng.uniform(2e3, 2e4, (b, 1)) * rng.dirichlet(np.ones(c), b)
    amp = flux / (2 * np.pi * sig[0] * sig[1])
    amp[::9] = 0.0
    mx = oxy[:, :1] + rng.uniform(2.0, side - 3.0, (b, c))
    my = oxy[:, 1:] + rng.uniform(2.0, side - 3.0, (b, c))
    pix = side * side
    px = origins[:, :1] + np.tile(np.arange(side), side)[None, :]      # [S, P]
    py = origins[:, 1:] + np.repeat(np.arange(side), side)[None, :]
    sky = rng.uniform(90.0, 110.0, (n_sets, pix))
    lam = np.empty_like(sky)
    for k in range(n_sets):                     # a set at a time: [C, P] temporaries
        i = k * rows_per_set
        dx, dy = px[k] - mx[i, :, None], py[k] - my[i, :, None]
        lam[k] = sky[k] + np.sum(amp[i, :, None] * np.exp(-0.5 * (
            pa[i, :, None] * dx ** 2 + 2 * pb[i, :, None] * dx * dy
            + pc[i, :, None] * dy ** 2)), axis=0)
    counts = rng.poisson(lam).astype(np.float64)
    mask = (rng.uniform(size=(n_sets, pix)) > 0.02).astype(np.float64)
    pad = -pix % LANE
    sets = [np.pad(a, ((0, 0), (0, pad)), constant_values=v)
            for a, v in ((px, 0.0), (py, 0.0), (counts, 0.0), (sky, 1.0), (mask, 0.0))]
    f32 = [np.ascontiguousarray(a, dtype=np.float32) for a in (amp, mx, my, pa, pb, pc, *sets)]
    return tuple(f32[:6]), tuple(f32[6:])


def _loglik_bwd_torch(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, g):
    """The backward kernel's algebra, dense: the cotangents of the six
    planes, given the cotangent ``g`` [B] of the output.  Independent of
    ``centered``: centering adds parameter-free terms only."""
    dx = px[:, None, :] - mx[..., None]          # [B, C, P]
    dy = py[:, None, :] - my[..., None]
    pa_, pb_, pc_ = pa[..., None], pb[..., None], pc[..., None]
    e = torch.exp(-0.5 * pa_ * dx * dx - pb_ * dx * dy - 0.5 * pc_ * dy * dy)
    lam = sky + torch.sum(amp[..., None] * e, dim=1)                  # [B, P]
    active = (lam > LAMBDA_MIN).to(lam.dtype)
    g_lam = (g[:, None] * mask) * (counts / torch.clamp(lam, min=LAMBDA_MIN) - 1.0) * active
    ge = g_lam[:, None, :] * e
    dq = -0.5 * ge * amp[..., None]
    return (ge.sum(-1),
            (dq * -2.0 * (pa_ * dx + pb_ * dy)).sum(-1),
            (dq * -2.0 * (pb_ * dx + pc_ * dy)).sum(-1),
            (dq * dx * dx).sum(-1),
            (2.0 * dq * dx * dy).sum(-1),
            (dq * dy * dy).sum(-1))


# ---------------------------------------------------------------------------
# K1's and K7's launch geometry
# ---------------------------------------------------------------------------

def _max_cb(n_chains: int, n_sets: int) -> int:
    """The most chains a block may take: WARPS with one pixel set; with S
    sets the largest power of two (at most WARPS) dividing the rows per set
    R = B / S, so a block's chains, which share one staged pixel chunk, lie
    in one set (CB = 1 at R = 1)."""
    if n_sets <= 1:
        return WARPS
    r = n_chains // n_sets
    cb = WARPS
    while r % cb:
        cb //= 2
    return cb


def _split(n_chains: int, n_pix: int, max_t: int, max_cb: int = WARPS) -> tuple[int, int]:
    """(CB, T): from CB = ``max_cb`` (8 with one pixel set), T = 1 (pixel
    arrays staged once serve CB chains), while the grid of ceil(B / CB) * T
    blocks is smaller than the card's SM count, first give each chain more
    warps (CB 8 -> 4 -> 2 -> 1), then more blocks (T doubling up to
    ``max_t``) while each block keeps at least one 32-pixel group."""
    n_groups = -(-n_pix // 32)
    cb, t = max_cb, 1
    while -(-n_chains // cb) * t < N_SM:
        if cb > 1:
            cb //= 2
        elif 2 * t <= min(max_t, n_groups):
            t *= 2
        else:
            break
    return cb, t


def k1_geometry(n_chains: int, n_pix: int, n_sets: int = 1) -> tuple[int, int]:
    """(CB, T) for K1: chains per block and blocks per cluster (T <= 8, the
    portable cluster size).  B = 65536 launches 8192 blocks of 8 chains, and
    B = 32 or 64 one chain per block in clusters of 8 or 4: 256 blocks.  The
    component count does not enter: it sets the shared memory, not the
    shape.  With ``n_sets`` pixel sets CB divides the rows per set: the
    field's detection and classify rows (R = 1, 2) run one chain per block,
    its groups (R = 8, 32 chains) up to 8."""
    return _split(n_chains, n_pix, MAX_CLUSTER, _max_cb(n_chains, n_sets))


def k7_geometry(n_chains: int, n_pix: int, n_sets: int = 1) -> tuple[int, int]:
    """(CB, T) for K7: chains per block and pixel tiles per chain.  K7 sums
    nothing over pixels, so its tiles are independent blocks with no cluster
    and no cap on T but the pixel groups.  B = 65536 launches 8192 blocks of
    8 chains; the PPC's B = 32 one chain per block in 8 tiles (256 blocks),
    B = 64 in 4; config 5's field at B = 1024 4 chains per block (256).
    ``n_sets`` as in :func:`k1_geometry`."""
    return _split(n_chains, n_pix, n_pix, _max_cb(n_chains, n_sets))


def whole_row_smem(kernel: str, cb: int, n_comp: int) -> int:
    """Shared-memory bytes of a block that stages its CB rows' ``n_comp``
    components whole (``csrc/mog_field.cu`` fwd_smem_bytes, bwd_smem_bytes,
    render_smem_bytes): ``kernel`` is "fwd", "bwd" or "render"."""
    chunk = 32 * CHUNK_GROUPS
    comps = 32 * cb * n_comp                # two float4 a component
    if kernel == "fwd":
        return comps + chunk * 20 + (chunk + WARPS + cb) * 4
    if kernel == "bwd":
        n_pad = -(-n_comp // BWD_ENTRIES) * BWD_ENTRIES
        return 32 * cb * n_pad + chunk * 20 + (cb * chunk + WARPS * n_pad * 6) * 4
    if kernel == "render":
        return comps + chunk * 12
    raise ValueError(kernel)


def components_staged(kernel: str, cb: int, n_comp: int) -> bool:
    """Whether ``kernel`` ("fwd", "bwd" or "render") at CB chains a block
    takes the staged path: only where the whole rows would not fit a
    block's shared memory, so that every shape that fits keeps the
    whole-row path.  The one-pass backward (C <= 4) stages no component.
    The wrappers look it up at each call (the card tests and the smoke
    replace it to hold the two paths bitwise equal where both fit)."""
    if kernel == "bwd" and n_comp <= 4:
        return False
    return whole_row_smem(kernel, cb, n_comp) > SMEM_OPTIN


def k1_pixel_slices(n_pix: int, cb: int, t: int) -> list[list[int]]:
    """The pixels each of a chain's T * (8 / CB) warps takes in K1 and K7,
    in the order a lane meets them (the kernels' slicing, written out): rank
    r of the cluster (K7: tile r) owns 32-pixel groups [r G / T, (r + 1) G /
    T) of the G = ceil(P / 32), walked in chunks of CHUNK_GROUPS groups, of
    which the chain's warp w takes w, w + 8 / CB, ...; lane l takes pixel
    32 g + l of group g, and pixels at or past P are padding.  Entry
    r * (8 / CB) + w."""
    n_groups = -(-n_pix // 32)
    n_sub = WARPS // cb
    out = []
    for r in range(t):
        lo, hi = n_groups * r // t, n_groups * (r + 1) // t
        for w in range(n_sub):
            pix = []
            for g0 in range(lo, hi, CHUNK_GROUPS):
                for g in range(g0 + w, min(g0 + CHUNK_GROUPS, hi), n_sub):
                    pix.extend(p for p in range(32 * g, 32 * g + 32) if p < n_pix)
            out.append(pix)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes wrappers
# ---------------------------------------------------------------------------

LIBRARY = Library("mog_field", ("mog_field.cu",), {
    "mog_field_loglik_fwd": "p" * 12 + "i" * 8 + "p",
    "mog_field_loglik_bwd": "p" * 19 + "i" * 7 + "p",
    "mog_field_render": "p" * 10 + "i" * 7 + "p",
})
build_kernels = LIBRARY.build
launch_counts, reset_launch_counts = LIBRARY.launch_counts, LIBRARY.reset_launch_counts


def _check_inputs(planes, pixels, extra=()):
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device with planes [B, C] and pixels [S, P], S dividing B.  Returns (B,
    C, P, S, device)."""
    amp = planes[0]
    if amp.dim() != 2:
        raise ValueError(f"planes must be [B, C], got {tuple(amp.shape)}")
    if pixels[0].dim() != 2:
        raise ValueError(f"pixel arrays must be [S, P], got {tuple(pixels[0].shape)}")
    n_sets, n_pix = pixels[0].shape
    if n_sets < 1 or amp.shape[0] % n_sets:
        raise ValueError(f"{amp.shape[0]} rows do not split into {n_sets} pixel sets")
    device = cuda_device(amp)
    for t in planes:
        check_tensor(t, "plane", amp.shape, device)
    for t in pixels:
        check_tensor(t, "pixel array", (n_sets, n_pix), device)
    for t, shape, name in extra:
        check_tensor(t, name, shape, device)
    return amp.shape[0], amp.shape[1], n_pix, n_sets, device


def loglik_fwd_cuda(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask,
                    centered: bool = False):
    """Launch the forward kernel: [B] log-likelihoods on the planes' card,
    on the path :func:`components_staged` picks."""
    planes = (amp, mx, my, pa, pb, pc)
    pixels = (px, py, counts, sky, mask)
    b, c, p, s, device = _check_inputs(planes, pixels)
    out = torch.empty(b, dtype=torch.float32, device=device)
    if b:
        cb, t = k1_geometry(b, p, s)
        LIBRARY.launch("mog_field_loglik_fwd", device, *ptrs(planes), *ptrs(pixels),
                       out.data_ptr(), b, c, p, s, int(bool(centered)), cb, t,
                       int(components_staged("fwd", cb, c)), at={"B": b, "C": c})
    return out


def loglik_bwd_cuda(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, g):
    """Launch the backward kernel: the six [B, C] plane cotangents.  The
    staged path keeps each pixel's g_lam in a [B, P] float32 scratch that
    this wrapper allocates."""
    planes = (amp, mx, my, pa, pb, pc)
    pixels = (px, py, counts, sky, mask)
    b, c, p, s, device = _check_inputs(planes, pixels, extra=[(g, (amp.shape[0],), "g")])
    grads = tuple(torch.empty(b, c, dtype=torch.float32, device=device) for _ in range(6))
    if b:
        cb, t = k1_geometry(b, p, s)
        staged = components_staged("bwd", cb, c)
        glam = torch.empty(b, p, dtype=torch.float32, device=device) if staged else None
        LIBRARY.launch("mog_field_loglik_bwd", device, *ptrs(planes), *ptrs(pixels),
                       g.data_ptr(), *ptrs(grads), None if glam is None else glam.data_ptr(),
                       b, c, p, s, cb, t, int(staged), at={"B": b, "C": c})
    return grads


def render_cuda(amp, mx, my, pa, pb, pc, px, py, sky):
    """Launch the render kernel: lambda [B, P] on the planes' card, on the
    path :func:`components_staged` picks."""
    planes = (amp, mx, my, pa, pb, pc)
    pixels = (px, py, sky)
    b, c, p, s, device = _check_inputs(planes, pixels)
    out = torch.empty(b, p, dtype=torch.float32, device=device)
    if b and p:
        cb, t = k7_geometry(b, p, s)
        LIBRARY.launch("mog_field_render", device, *ptrs(planes), *ptrs(pixels),
                       out.data_ptr(), b, c, p, s, cb, t,
                       int(components_staged("render", cb, c)), at={"B": b, "C": c})
    return out


class _LoglikKernel(torch.autograd.Function):
    """Forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, centered):
        ctx.save_for_backward(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask)
        return loglik_fwd_cuda(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, centered)

    @staticmethod
    def backward(ctx, g):
        grads = loglik_bwd_cuda(*ctx.saved_tensors, g.contiguous())
        return (*grads,) + (None,) * 6


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def mog_field_loglik(amp, mx, my, pa, pb, pc, pixel_data, *, centered: bool = False):
    """Poisson log-likelihood of a batched MoG field.

    ``amp..pc``: [B, C] float32 planes (amplitude with the normaliser folded
    in: ``amp = weight * exp(lognorm)``); ``pixel_data`` from
    :func:`stamp_pixel_data`, or [S, P] pixel sets from
    :func:`pad_pixel_sets` (row b reads set b // (B / S)).  Returns [B].
    Differentiable on both devices.
    """
    px, py, counts, sky, mask = pixel_data
    if amp.device.type == "cuda":
        planes = [t.contiguous() for t in (amp, mx, my, pa, pb, pc)]
        return _LoglikKernel.apply(*planes, px, py, counts, sky, mask, bool(centered))
    if amp.device.type == "cpu":
        return _loglik_torch(amp, mx, my, pa, pb, pc,
                             *rows_of_sets(pixel_data, amp.shape[0]), centered)
    raise ValueError(f"mog_field_loglik has no implementation on {amp.device}")


def mog_field_render(amp, mx, my, pa, pb, pc, pixel_data):
    """Expected-count images lambda [B, PIX_PAD] of a batched MoG field,
    padded pixels included (they hold px = py = 0 and sky = 1).  The
    likelihood never forms lambda; this is the posterior-predictive,
    CLEAN-subtraction and visualisation path.  ``pixel_data`` may be [S, P]
    pixel sets, as in :func:`mog_field_loglik`.  Not differentiable."""
    px, py, _, sky, _ = pixel_data
    if amp.device.type == "cuda":
        planes = [t.contiguous() for t in (amp, mx, my, pa, pb, pc)]
        return render_cuda(*planes, px, py, sky)
    if amp.device.type == "cpu":
        px, py, sky = rows_of_sets((px, py, sky), amp.shape[0])
        return _render_torch(amp, mx, my, pa, pb, pc, px, py, sky)
    raise ValueError(f"mog_field_render has no implementation on {amp.device}")


# ---------------------------------------------------------------------------
# model integration: flat parameter batches -> fused loglik
# ---------------------------------------------------------------------------

def _field_planes(vecs, stamp, band, kind: str, n_bands: int):
    """[B, D] unconstrained source vectors -> six [B, C] planes in
    precision form with the normalisers folded into the amplitude."""
    from celeste_tpu_torch.model.params import GalaxyParams, StarParams
    from celeste_tpu_torch.model.render import galaxy_unit_mog, star_unit_mog
    from celeste_tpu_torch.mog import precision_form

    if kind == "star":
        params = StarParams.from_vector(vecs, n_bands)
        unit = star_unit_mog(params, stamp)
    elif kind == "galaxy":
        params = GalaxyParams.from_vector(vecs, n_bands)
        unit = galaxy_unit_mog(params, stamp)
    else:
        raise ValueError(kind)
    w, mu, prec, lognorm = precision_form(unit)
    amp = stamp.iota * params.flux[..., band, None] * w * torch.exp(lognorm)
    shape = mu.shape[:-1]   # [B, C]: a star's PSF terms are shared by every chain
    planes = (amp, mu[..., 0], mu[..., 1], prec[..., 0], prec[..., 1], prec[..., 2])
    return tuple(t.expand(shape) for t in planes)


def mixed_field_planes(vecs, stamp, band, n_bands: int, is_star):
    """Kind-agnostic planes of mixed star/galaxy sources, for the sharded
    crowded field (counterpart of ``celeste_tpu/kernels/mog_field.py:266``).

    ``vecs`` [N, 6 + n_bands]: rectangular unconstrained vectors (a star
    uses the first 2 + n_bands slots; the rest are padding); ``is_star`` [N]
    bool: each row's kind, as data, since a shard's kind pattern is data.
    The batch of sources goes through one call of each branch.

    Returns six [N, N_GAL * K] planes in the block layout of the tiled
    kernels: block j (K = PSF components wide) holds components j*K ..
    (j+1)*K - 1; a star fills block 0 and leaves zero amplitude elsewhere,
    a galaxy fills all N_GAL blocks.

    Both branches are computed for every row, so a star's free-floating
    shape slots are clamped to [-12, 12] first: otherwise exp of a slot can
    overflow, and the 0 * inf in the backward of the branch ``torch.where``
    did not select would poison the star's gradient with NaN.
    """
    head = vecs[..., :2 + n_bands]
    shape_raw = torch.clamp(vecs[..., 2 + n_bands:], -12.0, 12.0)
    g_planes = _field_planes(torch.cat([head, shape_raw], dim=-1), stamp, band, "galaxy",
                             n_bands)
    s_planes = _field_planes(head, stamp, band, "star", n_bands)
    pad = g_planes[0].shape[-1] - s_planes[0].shape[-1]
    star = is_star[..., None]
    return tuple(torch.where(star, F.pad(sp, (0, pad)), gp) for gp, sp in zip(g_planes, s_planes))


IMPLS = ("general", "sep")


def batched_stamp_loglik(vecs, stamp, band=0, kind: str = "star", n_bands: int = 5,
                         pixel_data=None, centered: bool = False, impl: str = "general"):
    """Fused likelihood of a [B, D] batch of unconstrained source vectors
    against one stamp -> [B].  The [B, C] parameter preparation is plain
    PyTorch; the [B, PIX] work runs in the kernel.  Differentiable.  This is
    the function the samplers and the evals/s measurement drive.

    ``impl`` picks the kernel (JAX's names in brackets):

    - ``"general"`` (``"pallas"``, ``"pallas_general"``): the general stamp
      kernel K1, the default;
    - ``"sep"`` (``"pallas_sep"``): the separable kernel K8 of
      ``kernels/mog_field_sep.py``, taken for ``kind="star"`` when the
      stamp's PSF is isotropic (checked on the host, per call); any other
      source or PSF goes to K1, as in JAX.  ``pixel_data`` is K1's and is
      not read on the separable path.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "sep" and kind == "star":
        from celeste_tpu_torch.kernels.mog_field_sep import (
            mog_field_loglik_isotropic, psf_is_isotropic, stamp_pixel_data_2d,
            star_planes_isotropic,
        )

        if psf_is_isotropic(stamp.psf):
            planes = star_planes_isotropic(vecs, stamp, band, n_bands)
            return mog_field_loglik_isotropic(*planes, stamp_pixel_data_2d(stamp),
                                              centered=centered)
    planes = _field_planes(vecs, stamp, band, kind, n_bands)
    if pixel_data is None:
        pixel_data = stamp_pixel_data(stamp)
    return mog_field_loglik(*planes, pixel_data, centered=centered)
