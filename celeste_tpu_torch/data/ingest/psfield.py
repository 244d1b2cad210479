"""SDSS psField PSF reconstruction (SURVEY.md C2: the reference fits its
~3-component MoG PSF from SDSS psField files).

psField HDUs 1-5 (one per band u,g,r,i,z) store a Karhunen-Loeve PSF
expansion (public SDSS data model, psField table):

  columns per row (one row per eigenimage):
    NROW_B, NCOL_B — spatial polynomial degree bounds,
    RNROW, RNCOL   — eigenimage dimensions,
    C              — polynomial coefficients [NROW_B, NCOL_B],
    RROWS          — flattened eigenimage [RNROW * RNCOL];
  PSF at CCD position (row, col):
    img = sum_k ( sum_{i,j} C_k[i,j] * (row*5e-4)^i * (col*5e-4)^j ) * eigen_k.

``psf_at_position`` rebuilds the pixelized PSF, and ``psfield_to_mog``
chains it into the EM MoG fit (model/psf.fit_psf_mog) — the complete
psField -> MoG2D path the reference uses.  Tested against synthesized
psField-format files.
"""

from __future__ import annotations

import numpy as np

from celeste_tpu_torch.data.ingest.fits_lite import read_fits

RCS = 5.0e-4   # SDSS KL coordinate scaling


def psf_at_position(hdu_data: dict, row: float, col: float) -> np.ndarray:
    """Reconstruct the PSF image at CCD (row, col) from one band's psField
    table (dict of columns, one entry per eigenimage)."""
    nrow_b = np.atleast_1d(np.asarray(hdu_data["NROW_B"], np.int64))
    ncol_b = np.atleast_1d(np.asarray(hdu_data["NCOL_B"], np.int64))
    rnrow = np.atleast_1d(np.asarray(hdu_data["RNROW"], np.int64))
    rncol = np.atleast_1d(np.asarray(hdu_data["RNCOL"], np.int64))
    c = np.asarray(hdu_data["C"], np.float64)        # [K, nb, nb] or [K, nb*nb]
    rrows = np.asarray(hdu_data["RROWS"], np.float64)  # [K, rnrow*rncol]
    k = rrows.shape[0]

    rowsc, colsc = row * RCS, col * RCS
    img = None
    for ki in range(k):
        nb_r, nb_c = int(nrow_b[ki]), int(ncol_b[ki])
        ck = c[ki]
        if ck.ndim == 1:
            ck = ck.reshape(-1)[: nb_r * nb_c].reshape(nb_r, nb_c)
        else:
            ck = ck[:nb_r, :nb_c]
        coeff = 0.0
        for i in range(nb_r):
            for j in range(nb_c):
                coeff += ck[i, j] * (rowsc ** i) * (colsc ** j)
        eig = rrows[ki][: int(rnrow[ki]) * int(rncol[ki])].reshape(
            int(rnrow[ki]), int(rncol[ki]))
        img = coeff * eig if img is None else img + coeff * eig
    return img


def psfield_to_mog(path_or_bytes, band: int = 2, row: float = 500.0,
                   col: float = 1000.0, n_comp: int = 3):
    """psField file -> MoG2D PSF at the given CCD position (the reference's
    per-image PSF, C2).  ``band``: 0..4 selects HDU band+1."""
    from celeste_tpu_torch.model.psf import fit_psf_mog

    hdus = read_fits(path_or_bytes)
    data = hdus[band + 1]["data"]
    img = psf_at_position(data, row, col)
    img = np.clip(img, 0.0, None)
    return fit_psf_mog(img, n_comp=n_comp)
