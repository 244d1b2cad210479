"""Image stamp on a device, plus the fp64 host WCS.

Counterpart of ``celeste_tpu/model/stamp.py``.  A ``Stamp`` holds one
band's cutout as float32 tensors on one device.  Source positions on the
device are arcsecond offsets from a per-scene reference point; the host
converts absolute fp64 (ra, dec) to offsets once (``HostWcs``), and the
stamp stores the fp32 affine ``pixel = wcs_p0 + wcs_A @ du``.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.mog import MoG2D

ARCSEC_PER_DEG = 3600.0
SDSS_PIXEL_SCALE_ARCSEC = 0.396


class Stamp:
    """One band's cutout with everything the forward model needs.

    counts : [H, W] float32 — observed photo-electron counts.
    sky : [H, W] float32 — expected background counts per pixel.
    iota : 0-d float32 — photo-electrons per nanomaggie.
    mask : [H, W] float32 — 1 for valid pixels, 0 for masked.
    psf : MoG2D — zero-centered PSF mixture in pixel coordinates.
    wcs_A : [2, 2] float32 — d(pixel)/d(arcsec offset).
    wcs_p0 : [2] float32 — pixel (x, y) of the scene reference point.
    band : int — band index (u, g, r, i, z = 0..4); a tensor of band
        indices on a stack of stamps (:func:`stack_stamps`).
    """

    def __init__(self, counts, sky, iota, mask, psf: MoG2D, wcs_A, wcs_p0, band=2):
        self.counts = counts
        self.sky = sky
        self.iota = iota
        self.mask = mask
        self.psf = psf
        self.wcs_A = wcs_A
        self.wcs_p0 = wcs_p0
        self.band = band if torch.is_tensor(band) else int(band)

    @property
    def device(self):
        return self.counts.device

    def to(self, device) -> "Stamp":
        return Stamp(self.counts.to(device), self.sky.to(device), self.iota.to(device),
                     self.mask.to(device), self.psf.to(device), self.wcs_A.to(device),
                     self.wcs_p0.to(device), self.band)

    def duas2pixel(self, du):
        """Arcsec offset [..., 2] from the scene reference -> (x, y) pixel.
        Elementwise, not ``@``, so the result is float32-exact everywhere."""
        a = self.wcs_A
        x = a[0, 0] * du[..., 0] + a[0, 1] * du[..., 1]
        y = a[1, 0] * du[..., 0] + a[1, 1] * du[..., 1]
        return self.wcs_p0 + torch.stack([x, y], dim=-1)

    def pixel_grid(self):
        """Flat pixel-centre coordinates (px [PIX], py [PIX]) in C order;
        pixel (i, j) is centred at integer coordinates."""
        h, w = self.counts.shape
        kw = dict(dtype=torch.float32, device=self.device)
        py_grid, px_grid = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw),
                                          indexing="ij")
        return px_grid.reshape(-1), py_grid.reshape(-1)

    def sky_jacobian_arcsec(self):
        """d(pixel)/d(arcsec): maps on-sky galaxy shape covariances into
        pixel coordinates.  Identical to ``wcs_A`` under the offset
        convention."""
        return self.wcs_A


class HostWcs:
    """Host-side (fp64 NumPy) tangent-plane WCS: absolute (ra, dec) degrees
    <-> pixels, and the fp32 offset affine handed to ``Stamp``.

    ``u_ref`` (deg) is the scene reference point; arcsec offsets are
    du = ((ra - ra0) * 3600 * cos(dec0), (dec - dec0) * 3600).
    """

    def __init__(self, pixel_scale_arcsec: float = SDSS_PIXEL_SCALE_ARCSEC,
                 u_ref=(0.0, 0.0), p_ref=(0.0, 0.0), rot_deg: float = 0.0):
        self.u_ref = np.asarray(u_ref, np.float64)
        self.p_ref = np.asarray(p_ref, np.float64)
        self.cosd = np.cos(np.deg2rad(self.u_ref[1]))
        c, s = np.cos(np.deg2rad(rot_deg)), np.sin(np.deg2rad(rot_deg))
        # px per arcsec of (east, north) offset
        self.A_as = np.array([[c, -s], [s, c]], np.float64) / pixel_scale_arcsec

    def equa2duas(self, u):
        u = np.asarray(u, np.float64)
        return np.array([
            (u[..., 0] - self.u_ref[0]) * ARCSEC_PER_DEG * self.cosd,
            (u[..., 1] - self.u_ref[1]) * ARCSEC_PER_DEG,
        ]).T if u.ndim > 1 else np.array([
            (u[0] - self.u_ref[0]) * ARCSEC_PER_DEG * self.cosd,
            (u[1] - self.u_ref[1]) * ARCSEC_PER_DEG,
        ])

    def duas2equa(self, du):
        du = np.asarray(du, np.float64)
        return np.array([
            self.u_ref[0] + du[0] / (ARCSEC_PER_DEG * self.cosd),
            self.u_ref[1] + du[1] / ARCSEC_PER_DEG,
        ])

    def equa2pixel(self, u):
        return self.p_ref + self.A_as @ self.equa2duas(u)

    def pixel2equa(self, p):
        du = np.linalg.solve(self.A_as, np.asarray(p, np.float64) - self.p_ref)
        return self.duas2equa(du)

    def device_affine(self, device="cpu"):
        """(wcs_A [2, 2] fp32 px/arcsec, wcs_p0 [2] fp32) for ``Stamp``."""
        return (torch.as_tensor(self.A_as, dtype=torch.float32, device=device),
                torch.as_tensor(self.p_ref, dtype=torch.float32, device=device))


def stack_stamps(stamps) -> Stamp:
    """Stack same-shape Stamps into one Stamp whose every field has a
    leading band axis (``band`` becomes a [N] int64 tensor)."""
    stamps = list(stamps)

    def stack(get):
        return torch.stack([get(s) for s in stamps])

    psf = MoG2D(stack(lambda s: s.psf.w), stack(lambda s: s.psf.mu), stack(lambda s: s.psf.cov))
    return Stamp(counts=stack(lambda s: s.counts), sky=stack(lambda s: s.sky),
                 iota=stack(lambda s: s.iota), mask=stack(lambda s: s.mask), psf=psf,
                 wcs_A=stack(lambda s: s.wcs_A), wcs_p0=stack(lambda s: s.wcs_p0),
                 band=torch.as_tensor([int(s.band) for s in stamps], device=stamps[0].device))
