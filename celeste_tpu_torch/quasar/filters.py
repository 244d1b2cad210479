"""Broadband filter throughput curves (counterpart of
``celeste_tpu/quasar/filters.py``).

PROVENANCE: no SDSS throughput tables ship with the repository.
``sdss_like_filterbank`` builds smooth log-normal-shaped throughput curves
matched to the published ugriz effective wavelengths and widths, adequate
for synthetic-data inference and tests; real throughput tables drop in
through ``FilterBank.from_tables``.  The curves are built in float64 NumPy,
exactly as the JAX package builds them, and held as float32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# (effective wavelength nm, FWHM nm) of the SDSS ugriz filters (public
# instrument summary numbers, rounded)
SDSS_BANDS = {
    "u": (355.1, 58.0),
    "g": (468.6, 138.0),
    "r": (616.6, 110.0),
    "i": (748.0, 130.0),
    "z": (893.2, 125.0),
}


class FilterBank(NamedTuple):
    """Throughputs sampled on per-band observed-frame wavelength grids.

    lam : [n_bands, n_pts] wavelength grid (nm)
    resp : [n_bands, n_pts] photon response, normalized so that
        sum(resp * lam * dlam) == 1 per band (band flux = sum f(lam) * resp
        * lam * dlam)
    dlam : [n_bands, n_pts] grid spacing
    names : tuple of band names
    """

    lam: torch.Tensor
    resp: torch.Tensor
    dlam: torch.Tensor
    names: tuple

    @property
    def n_bands(self):
        return self.lam.shape[0]

    def to(self, device) -> "FilterBank":
        return self._replace(lam=self.lam.to(device), resp=self.resp.to(device),
                             dlam=self.dlam.to(device))

    @classmethod
    def from_tables(cls, tables: dict, n_pts: int = 128, device="cpu"):
        """Build from {name: (lam_nm[N], throughput[N])} tables."""
        lams, resps, dlams, names = [], [], [], []
        for name, (lam, resp) in tables.items():
            lam = np.asarray(lam, np.float64)
            resp = np.asarray(resp, np.float64)
            grid = np.linspace(lam[0], lam[-1], n_pts)
            r = np.interp(grid, lam, resp)
            d = np.gradient(grid)
            norm = np.sum(r * grid * d)
            lams.append(grid)
            resps.append(r / norm)
            dlams.append(d)
            names.append(name)

        def t(rows):
            return torch.as_tensor(np.stack(rows), dtype=torch.float32, device=device)

        return cls(lam=t(lams), resp=t(resps), dlam=t(dlams), names=tuple(names))


def sdss_like_filterbank(n_pts: int = 128, device="cpu") -> FilterBank:
    """Smooth synthetic ugriz-like curves (see the module's provenance note)."""
    tables = {}
    for name, (center, fwhm) in SDSS_BANDS.items():
        sig = fwhm / 2.355
        lam = np.linspace(center - 3 * sig, center + 3 * sig, 256)
        # slightly asymmetric (red-skewed) smooth curve
        t = (lam - center) / sig
        resp = np.exp(-0.5 * t * t) * (1.0 + 0.15 * np.tanh(t))
        resp = np.clip(resp, 0.0, None)
        tables[name] = (lam, resp)
    return FilterBank.from_tables(tables, n_pts=n_pts, device=device)
