"""Separable Poisson log-likelihood of isotropic mixtures: kernel K8.

Counterpart of ``celeste_tpu/kernels/mog_field_sep.py``.  An isotropic
Gaussian factors over the pixel axes,

    exp(-((x - cx)^2 + (y - cy)^2) iv / 2) = exp(-(x - cx)^2 iv / 2) exp(-(y - cy)^2 iv / 2),

so a chain's C components need C (H + W) exponentials instead of C H W, and
lambda[h, w] = sky + sum_c col_c[h] row_c[w] is C multiply-adds per pixel.
Every PSF the repo builds is isotropic (``model/psf.py``), so this applies to
every star stamp; ``batched_stamp_loglik(impl="sep")`` selects it.

Chains carry four [B, C] float32 planes: ``amp`` (with the normaliser
``weight * iv / (2 pi)`` folded in), the centre ``cx``/``cy`` and the
inverse variance ``iv``.  Pixels come from :func:`stamp_pixel_data_2d` as
``xs`` [1, W], ``ys`` [1, H] and the [H, W] counts, sky and mask.  The TPU
version pads W to 128 lanes; the port does not (padding was masked and
contributed exactly 0, so values do not change).

Dispatch follows the tensors' device, with no switch and no fallback: CUDA
tensors launch ``csrc/mog_field_sep.cu`` (``mog_field_sep_fwd`` forward and,
under autograd, ``mog_field_sep_bwd`` backward); CPU tensors take the plain
:func:`_sep_loglik_torch`, whose gradient is torch autograd.
:func:`_sep_loglik_torch` and :func:`_sep_loglik_bwd_torch` are the
kernels' plain versions; :func:`_sep_loglik_bwd_moments_torch` writes the
backward kernel's moment form out and :func:`k8_lane_walk` its walk over
the pixels (both for the tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from celeste_tpu_torch.kernels._build import Library, check_tensor, cuda_device, ptrs
from celeste_tpu_torch.likelihood._pixel import LAMBDA_MIN, pixel_loglik

# the kernels' walk (csrc/mog_field_sep.cu kBandPix, kMaxBandRows): bands of
# whole rows, as many as fit BAND_PIX pixels, at most MAX_BAND_ROWS
BAND_PIX = 2048
MAX_BAND_ROWS = 32


def stamp_pixel_data_2d(stamp):
    """Axis-separable pixel data of a Stamp: (xs [1, W], ys [1, H],
    counts [H, W], sky [H, W], mask [H, W])."""
    h, w = stamp.counts.shape
    kw = dict(dtype=torch.float32, device=stamp.device)
    return (torch.arange(w, **kw)[None, :], torch.arange(h, **kw)[None, :],
            stamp.counts.contiguous(), stamp.sky.contiguous(), stamp.mask.contiguous())


# ---------------------------------------------------------------------------
# plain PyTorch versions of the two kernels
# ---------------------------------------------------------------------------

def _sep_factors(amp, cx, cy, iv, xs, ys):
    """(dx [B, C, W], dy [B, C, H], ex [B, C, W], rows = amp ex, cols [B, C, H])."""
    dx = xs[:, None, :] - cx[..., None]
    dy = ys[:, None, :] - cy[..., None]
    ex = torch.exp(-0.5 * iv[..., None] * dx * dx)
    cols = torch.exp(-0.5 * iv[..., None] * dy * dy)
    return dx, dy, ex, amp[..., None] * ex, cols


def _sep_lam(rows, cols, sky):
    """lambda [B, H, W] = sky + sum_c cols[b, c, h] rows[b, c, w], as a
    broadcast multiply-sum (no matmul, so no TF32 path)."""
    return sky + torch.sum(cols[..., :, None] * rows[..., None, :], dim=1)


def _sep_loglik_torch(amp, cx, cy, iv, xs, ys, counts, sky, mask, centered: bool = False):
    """The forward kernel's math, dense: [B, C] planes -> [B] log-likelihoods."""
    _, _, _, rows, cols = _sep_factors(amp, cx, cy, iv, xs, ys)
    lam = _sep_lam(rows, cols, sky)
    return torch.sum(pixel_loglik(lam, counts, centered) * mask, dim=(1, 2))


def _sep_loglik_bwd_torch(amp, cx, cy, iv, xs, ys, counts, sky, mask, g):
    """The backward kernel's algebra, dense: the cotangents of the four
    planes given the cotangent ``g`` [B] of the output.  The pixel cotangent
    contracts into R_c[w] = sum_h g_lam col_c[h] and G_c[h] = sum_w g_lam
    row_c[w]; each plane's cotangent is then a short sum over W or H.
    Independent of ``centered``."""
    dx, dy, ex, rows, cols = _sep_factors(amp, cx, cy, iv, xs, ys)
    lam = _sep_lam(rows, cols, sky)
    active = (lam > LAMBDA_MIN).to(lam.dtype)
    g_lam = (g[:, None, None] * mask) * (counts / torch.clamp(lam, min=LAMBDA_MIN) - 1.0) * active
    r = torch.sum(g_lam[:, None] * cols[..., :, None], dim=2)     # [B, C, W]
    s = torch.sum(g_lam[:, None] * rows[..., None, :], dim=3)     # [B, C, H]
    rr, ss = r * rows, s * cols
    return ((r * ex).sum(-1),
            iv * (rr * dx).sum(-1),
            iv * (ss * dy).sum(-1),
            -0.5 * ((rr * dx * dx).sum(-1) + (ss * dy * dy).sum(-1)))


def _sep_loglik_bwd_moments_torch(amp, cx, cy, iv, xs, ys, counts, sky, mask, g):
    """The backward kernel's moment form, dense: each column w sums over the
    rows R_c[w] = sum_h g_lam col_c[h], Y1_c[w] = sum_h g_lam col_c[h] dy and
    Y2_c[w] = sum_h g_lam col_c[h] dy^2, and the four cotangents are sums over
    the columns, d a = sum_w R_c ex_c, d cx = iv sum_w R_c row_c dx,
    d cy = iv sum_w row_c Y1_c, d iv = -(sum_w R_c row_c dx^2 + row_c Y2_c) / 2.
    Equal in exact arithmetic to :func:`_sep_loglik_bwd_torch`."""
    dx, dy, ex, rows, cols = _sep_factors(amp, cx, cy, iv, xs, ys)
    lam = _sep_lam(rows, cols, sky)
    active = (lam > LAMBDA_MIN).to(lam.dtype)
    g_lam = (g[:, None, None] * mask) * (counts / torch.clamp(lam, min=LAMBDA_MIN) - 1.0) * active
    gc = g_lam[:, None] * cols[..., :, None]                       # [B, C, H, W]
    r = gc.sum(2)                                                  # [B, C, W]
    y1 = (gc * dy[..., :, None]).sum(2)
    y2 = (gc * (dy * dy)[..., :, None]).sum(2)
    rr = r * rows
    return ((r * ex).sum(-1),
            iv * (rr * dx).sum(-1),
            iv * (rows * y1).sum(-1),
            -0.5 * (rr * dx * dx + rows * y2).sum(-1))


def k8_band_rows(h: int, w: int) -> int:
    """Rows per band of an h x w stamp in K8 (csrc/mog_field_sep.cu
    band_rows): as many as fit BAND_PIX pixels, at most MAX_BAND_ROWS and h,
    and at least one."""
    rows = BAND_PIX // w if w > 0 else MAX_BAND_ROWS
    return max(min(rows, MAX_BAND_ROWS, h), 1)


def k8_lane_walk(h: int, w: int) -> list[list[int]]:
    """The flat pixels (h_i * w + w_i) each of a chain's 32 lanes takes in
    K8, in the order it meets them (the kernels' walk, written out): bands of
    :func:`k8_band_rows` rows in row order; in each band, blocks of 32
    columns in order, lane l taking column w0 + l (none past w) and walking
    the band's rows."""
    nr = k8_band_rows(h, w)
    out = [[] for _ in range(32)]
    for h0 in range(0, h, nr):
        for w0 in range(0, w, 32):
            for lane in range(32):
                x = w0 + lane
                if x < w:
                    out[lane].extend(r * w + x for r in range(h0, min(h0 + nr, h)))
    return out


def random_sep_problem(b: int, c: int, h: int, w: int, seed: int = 0):
    """A random separable problem as float32 NumPy arrays, for checks of the
    kernels away from a star's stamp: star-like planes (amp, cx, cy, iv)
    [b, c] of c components around the stamp's centre, every 5th chain's
    first component at zero amplitude; xs [1, w], ys [1, h]; counts drawn
    from the planes' mean chain over a sky of ~100, a mask with every 7th
    column and one row masked; and a cotangent g [b]."""
    rng = np.random.default_rng(seed)
    var = rng.uniform(1.0, 6.0, (b, c))
    iv = 1.0 / var
    flux = rng.uniform(2e3, 2e4, (b, 1)) * rng.dirichlet(np.ones(c), b)
    amp = flux * iv / (2 * math.pi)
    amp[::5, 0] = 0.0
    cx = (w - 1) / 2 + rng.normal(0.0, 1.5, (b, 1)) + rng.normal(0.0, 0.5, (b, c))
    cy = (h - 1) / 2 + rng.normal(0.0, 1.5, (b, 1)) + rng.normal(0.0, 0.5, (b, c))
    xs, ys = np.arange(w, dtype=np.float64)[None], np.arange(h, dtype=np.float64)[None]
    sky = rng.uniform(90.0, 110.0, (h, w))
    rows = amp.mean(0)[:, None] * np.exp(-0.5 * iv.mean(0)[:, None]
                                         * (xs - cx.mean(0)[:, None]) ** 2)
    cols = np.exp(-0.5 * iv.mean(0)[:, None] * (ys - cy.mean(0)[:, None]) ** 2)
    counts = rng.poisson(sky + cols.T @ rows)
    mask = np.ones((h, w))
    mask[:, ::7] = 0.0
    mask[h // 2] = 0.0
    f32 = [np.ascontiguousarray(a, dtype=np.float32)
           for a in (amp, cx, cy, iv, xs, ys, counts, sky, mask, rng.normal(size=b))]
    return tuple(f32[:4]), tuple(f32[4:9]), f32[9]


def sep_as_k1(amp, cx, cy, iv, xs, ys, counts, sky, mask):
    """The same problem in K1's form: precision planes (amp, mx, my, pa, pb,
    pc) with pa = pc = iv, pb = 0, and the [1, H W] pixel arrays of the
    stamp's row-major pixels, so that K1 and K8 compute one likelihood."""
    h, w = counts.shape
    px = xs.expand(h, w).reshape(1, -1).contiguous()
    py = ys.reshape(h, 1).expand(h, w).reshape(1, -1).contiguous()
    return ((amp, cx, cy, iv, torch.zeros_like(iv), iv),
            (px, py, *(t.reshape(1, -1).contiguous() for t in (counts, sky, mask))))


# ---------------------------------------------------------------------------
# CUDA kernels: ctypes wrappers
# ---------------------------------------------------------------------------

LIBRARY = Library("mog_field_sep", ("mog_field_sep.cu",), {
    "mog_field_sep_fwd": "p" * 10 + "i" * 5 + "p",
    "mog_field_sep_bwd": "p" * 14 + "i" * 4 + "p",
})
build_kernels = LIBRARY.build
launch_counts, reset_launch_counts = LIBRARY.launch_counts, LIBRARY.reset_launch_counts


def _check_inputs(planes, pixels, extra=()):
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device with planes [B, C], xs [1, W], ys [1, H] and [H, W] images."""
    amp = planes[0]
    if amp.dim() != 2:
        raise ValueError(f"planes must be [B, C], got {tuple(amp.shape)}")
    if pixels[2].dim() != 2:
        raise ValueError(f"counts must be [H, W], got {tuple(pixels[2].shape)}")
    h, w = pixels[2].shape
    device = cuda_device(amp)
    named = ([(t, tuple(amp.shape), "plane") for t in planes]
             + [(pixels[0], (1, w), "xs"), (pixels[1], (1, h), "ys")]
             + [(t, (h, w), name) for t, name in zip(pixels[2:], ("counts", "sky", "mask"))]
             + list(extra))
    for t, shape, name in named:
        check_tensor(t, name, shape, device)
    return amp.shape[0], amp.shape[1], h, w, device


def sep_fwd_cuda(amp, cx, cy, iv, xs, ys, counts, sky, mask, centered: bool = False):
    """Launch the forward kernel: [B] log-likelihoods on the planes' card."""
    planes = (amp, cx, cy, iv)
    pixels = (xs, ys, counts, sky, mask)
    b, c, h, w, device = _check_inputs(planes, pixels)
    out = torch.empty(b, dtype=torch.float32, device=device)
    if b:
        LIBRARY.launch("mog_field_sep_fwd", device, *ptrs(planes), *ptrs(pixels),
                       out.data_ptr(), b, c, h, w, int(bool(centered)))
    return out


def sep_bwd_cuda(amp, cx, cy, iv, xs, ys, counts, sky, mask, g):
    """Launch the backward kernel: the four [B, C] plane cotangents."""
    planes = (amp, cx, cy, iv)
    pixels = (xs, ys, counts, sky, mask)
    b, c, h, w, device = _check_inputs(planes, pixels, extra=[(g, (amp.shape[0],), "g")])
    grads = tuple(torch.empty(b, c, dtype=torch.float32, device=device) for _ in range(4))
    if b:
        LIBRARY.launch("mog_field_sep_bwd", device, *ptrs(planes), *ptrs(pixels),
                       g.data_ptr(), *ptrs(grads), b, c, h, w)
    return grads


class _SepKernel(torch.autograd.Function):
    """Forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, amp, cx, cy, iv, xs, ys, counts, sky, mask, centered):
        ctx.save_for_backward(amp, cx, cy, iv, xs, ys, counts, sky, mask)
        return sep_fwd_cuda(amp, cx, cy, iv, xs, ys, counts, sky, mask, centered)

    @staticmethod
    def backward(ctx, g):
        grads = sep_bwd_cuda(*ctx.saved_tensors, g.contiguous())
        return (*grads,) + (None,) * 6


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def mog_field_loglik_isotropic(amp, cx, cy, inv_var, pixel_data, *, centered: bool = False):
    """Poisson log-likelihood of a batched isotropic MoG field.

    ``amp`` [B, C] carries the normaliser ``weight * inv_var / (2 pi)``;
    ``cx``/``cy`` [B, C] are pixel centres and ``inv_var`` [B, C] is
    1 / variance; ``pixel_data`` comes from :func:`stamp_pixel_data_2d`.
    Returns [B].  Differentiable on both devices.  ``centered``:
    saturated-model centering (``likelihood/_pixel.py``).
    """
    xs, ys, counts, sky, mask = pixel_data
    if amp.device.type == "cuda":
        planes = [t.contiguous() for t in (amp, cx, cy, inv_var)]
        return _SepKernel.apply(*planes, xs, ys, counts, sky, mask, bool(centered))
    if amp.device.type == "cpu":
        return _sep_loglik_torch(amp, cx, cy, inv_var, xs, ys, counts, sky, mask, centered)
    raise ValueError(f"mog_field_loglik_isotropic has no implementation on {amp.device}")


def star_planes_isotropic(vecs, stamp, band, n_bands: int):
    """[B, D] star vectors -> isotropic planes (amp, cx, cy, inv_var), each
    [B, K].  The stamp's PSF must be isotropic (cov = v I): the caller checks
    it once per stamp on the host (:func:`psf_is_isotropic`)."""
    from celeste_tpu_torch.model.params import StarParams

    params = StarParams.from_vector(vecs, n_bands)
    p = stamp.duas2pixel(params.u)
    inv_var = 1.0 / stamp.psf.cov[..., 0, 0]
    amp = stamp.iota * params.flux[..., band, None] * stamp.psf.w * inv_var / (2.0 * math.pi)
    cx = p[..., 0, None] + stamp.psf.mu[..., 0]
    cy = p[..., 1, None] + stamp.psf.mu[..., 1]
    return amp, cx, cy, inv_var.expand(amp.shape)


def psf_is_isotropic(psf, tol: float = 1e-6) -> bool:
    """Host-side check: every component circular within ``tol``."""
    cov = psf.cov.detach().cpu().numpy()
    return bool(
        np.all(np.abs(cov[..., 0, 1]) <= tol * np.abs(cov[..., 0, 0]))
        and np.all(np.abs(cov[..., 0, 0] - cov[..., 1, 1]) <= tol * np.abs(cov[..., 0, 0]))
    )
