"""SDSS frame ingest (SURVEY.md C1: the reference's ``FitsImage`` — load a
``frame-{band}-RRRRRR-C-FFFF.fits``, undo the calibration back to expected
photo-electron counts ``nelec``, expose the WCS and per-frame calibration).

SDSS frame files (public data model, dr12+):
  HDU0: sky-subtracted, calibrated image [nmgy], float32, with TAN WCS;
  HDU1: ``calib`` — float32 row vector [W], nanomaggies per count;
  HDU2: sky — BINTABLE with ALLSKY [ny, nx] grid + XINTERP/YINTERP vectors
        (sky in counts, to be bilinearly interpolated to full res);
  HDU3: photometric calibration table (unused here).

Reconstruction (inverting the frame pipeline):
  counts_dn(x, y)  = image(x, y) / calib(x) + sky_interp(x, y)
  nelec(x, y)      = counts_dn * gain
  iota(x)          = gain / calib(x)   [nelec per nanomaggie]

The reference keeps iota per-column; the Stamp carries a scalar iota, so
cutouts store the cutout-mean iota and fold the (sub-percent, smooth)
column variation into the per-pixel sky term — adequate for stamp-scale
inference and exactly invertible when needed.

The whole path is exercised by synthesizing frame files with ``fits_lite``'s
writer in tests/test_torch_ingest.py, against the JAX package's ingest.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from celeste_tpu_torch.data.ingest.fits_lite import read_fits


@dataclass
class TanWcs:
    """Gnomonic (TAN) WCS from standard FITS cards (CRVAL/CRPIX/CD).

    Implements the reference's ``equa2pixel``/``pixel2equa`` (C12) in fp64
    on the host, and exports the local affine for Stamp consumption.
    FITS convention: 1-indexed pixel centers; we convert to 0-indexed.
    """

    crval: np.ndarray   # [ra0, dec0] deg
    crpix: np.ndarray   # 1-indexed reference pixel [x, y]
    cd: np.ndarray      # [2,2] deg/pixel

    @classmethod
    def from_header(cls, h: dict) -> "TanWcs":
        return cls(
            crval=np.array([h["CRVAL1"], h["CRVAL2"]], np.float64),
            crpix=np.array([h["CRPIX1"], h["CRPIX2"]], np.float64),
            cd=np.array([[h["CD1_1"], h["CD1_2"]], [h["CD2_1"], h["CD2_2"]]],
                        np.float64),
        )

    def _to_native(self, ra, dec):
        """Sky -> intermediate world coords (gnomonic projection), deg."""
        ra0, dec0 = np.deg2rad(self.crval)
        ra, dec = np.deg2rad(ra), np.deg2rad(dec)
        cosc = np.sin(dec0) * np.sin(dec) + np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0)
        x = np.cos(dec) * np.sin(ra - ra0) / cosc
        y = (np.cos(dec0) * np.sin(dec) - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc
        return np.rad2deg(x), np.rad2deg(y)

    def _from_native(self, xi, eta):
        ra0, dec0 = np.deg2rad(self.crval)
        x, y = np.deg2rad(xi), np.deg2rad(eta)
        rho = np.hypot(x, y)
        c = np.arctan(rho)
        with np.errstate(invalid="ignore"):
            dec = np.where(
                rho == 0, dec0,
                np.arcsin(np.cos(c) * np.sin(dec0) + y * np.sin(c) * np.cos(dec0) / np.maximum(rho, 1e-300)),
            )
            ra = ra0 + np.where(
                rho == 0, 0.0,
                np.arctan2(x * np.sin(c),
                           rho * np.cos(dec0) * np.cos(c) - y * np.sin(dec0) * np.sin(c)),
            )
        return np.rad2deg(ra), np.rad2deg(dec)

    def equa2pixel(self, u):
        xi, eta = self._to_native(u[0], u[1])
        p = np.linalg.solve(self.cd, np.array([xi, eta]))
        return p + self.crpix - 1.0

    def pixel2equa(self, p):
        xi, eta = self.cd @ (np.asarray(p, np.float64) - self.crpix + 1.0)
        ra, dec = self._from_native(xi, eta)
        return np.array([ra, dec])

    def local_affine_arcsec(self, p0):
        """d(pixel)/d(true east-north arcsec) at pixel p0 (for Stamp)."""
        u0 = self.pixel2equa(p0)
        eps = 0.1 / 3600.0  # 0.1 arcsec in deg
        cosd = np.cos(np.deg2rad(u0[1]))
        de = self.equa2pixel([u0[0] + eps / cosd, u0[1]]) - np.asarray(p0)
        dn = self.equa2pixel([u0[0], u0[1] + eps]) - np.asarray(p0)
        a = np.stack([de, dn], axis=1) / (eps * 3600.0)
        return a, u0


def _interp_sky(allsky, xinterp, yinterp):
    """Bilinear interpolation of the low-res sky grid to full frame
    resolution (the frame pipeline's convention)."""
    ny, nx = allsky.shape
    xq = np.clip(xinterp, 0, nx - 1)
    yq = np.clip(yinterp, 0, ny - 1)
    x0 = np.floor(xq).astype(int)
    y0 = np.floor(yq).astype(int)
    x1 = np.minimum(x0 + 1, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    fx = (xq - x0)[None, :]
    fy = (yq - y0)[:, None]
    a = allsky[np.ix_(y0, x0)]
    b = allsky[np.ix_(y0, x1)]
    c = allsky[np.ix_(y1, x0)]
    d = allsky[np.ix_(y1, x1)]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def frame_to_stamp(path_or_bytes, center_radec, size: int, gain: float = 4.6,
                   psf=None, band: int = 2, device="cuda"):
    """Cut a ``size x size`` stamp around ``center_radec`` from an SDSS
    frame file and return a ``Stamp`` on ``device`` (counts in
    photo-electrons, per-pixel sky, scalar iota, local affine WCS).  The
    reconstruction and the fp64 WCS stay on the host; only the float32
    results go to the device.

    ``psf``: a MoG2D (e.g. from ``fit_psf_mog`` on the psField eigen-image,
    C2); defaults to an SDSS-like seeing model when absent.
    """
    import torch

    from celeste_tpu_torch.experiments import resolve_device
    from celeste_tpu_torch.model.psf import sdss_like_psf
    from celeste_tpu_torch.model.stamp import Stamp

    device = resolve_device(str(device))

    hdus = read_fits(path_or_bytes)
    img = np.asarray(hdus[0]["data"], np.float64)            # [H, W] nmgy
    calib = np.asarray(hdus[1]["data"], np.float64).ravel()  # [W]
    # sky: ALLSKY [gy, gx] grid (one table row per grid row) in HDU2;
    # XINTERP [W] / YINTERP [H] single-row columns in HDU3.  (Real DR
    # frames pack all three into one row with TDIMn; converting is a
    # one-line reshape once TDIM support lands — layout documented here so
    # artifacts written by fits_lite round-trip.)
    allsky = np.asarray(hdus[2]["data"]["ALLSKY"], np.float64)
    interp_tab = hdus[3]["data"] if len(hdus) > 3 and "XINTERP" in (hdus[3]["data"] or {}) \
        else hdus[2]["data"]
    xinterp = np.asarray(interp_tab["XINTERP"], np.float64).ravel()
    yinterp = np.asarray(interp_tab["YINTERP"], np.float64).ravel()
    sky_dn = _interp_sky(allsky, xinterp, yinterp)           # [H, W] counts

    wcs = TanWcs.from_header(hdus[0]["header"])
    p_center = wcs.equa2pixel(np.asarray(center_radec, np.float64))
    h, w = img.shape
    x0 = int(round(p_center[0])) - size // 2
    y0 = int(round(p_center[1])) - size // 2
    x0 = max(0, min(x0, w - size))
    y0 = max(0, min(y0, h - size))
    sl = np.s_[y0:y0 + size, x0:x0 + size]

    dn = img[sl] / calib[None, x0:x0 + size] + sky_dn[sl]
    nelec = dn * gain
    sky_nelec = sky_dn[sl] * gain
    iota_cols = gain / calib[x0:x0 + size]                   # nelec per nmgy
    iota = float(iota_cols.mean())

    p0 = np.array([x0 + size / 2.0, y0 + size / 2.0])
    a_as, u0 = wcs.local_affine_arcsec(p0)

    psf = (psf or sdss_like_psf()).to(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    stamp = Stamp(
        counts=f32(nelec),
        sky=f32(sky_nelec),
        iota=f32(iota),
        mask=torch.ones((size, size), dtype=torch.float32, device=device),
        psf=psf,
        wcs_A=f32(a_as),
        wcs_p0=f32(p0 - np.array([x0, y0])),
        band=band,
    )
    return stamp, {"u_ref": u0, "pixel_origin": (x0, y0), "wcs": wcs,
                   "iota_columns": iota_cols}
