"""BOSS/SDSS optical-spectrum ingest (SURVEY.md C16 — the reference's
quasar pipeline consumes spec-PLATE-MJD-FIBER.fits files downloaded from
SAS; reconstructed layout, no reference file:line possible — empty mount).

File layout (SDSS-III/IV data model for ``spec`` files):
- HDU0: primary header (no data);
- HDU1 ``COADD``: BINTABLE, one row per pixel — FLUX (1E, 1e-17 erg/s/cm^2/A),
  LOGLAM (1E, log10 of wavelength in Angstrom), IVAR (1E), AND_MASK (1J),
  OR_MASK (1J), [WDISP, SKY, MODEL];
- HDU2 ``SPALL``: one-row BINTABLE of catalog quantities — Z (1E),
  ZWARNING (1J), CLASS (6A), ...

Correctness is gated on a golden fixture assembled directly from this data
model by an independent generator
(tests/fixtures/make_golden_fits.py) — the same de-circularization contract
as the image/psField ingest.
"""

from __future__ import annotations

import numpy as np

from celeste_tpu_torch.data.ingest.fits_lite import read_fits


def _find_bintable(hdus, required_cols, extname=None):
    for hdu in hdus:
        data = hdu["data"]
        if not isinstance(data, dict):
            continue
        if extname is not None:
            name = str(hdu["header"].get("EXTNAME", "")).strip().upper()
            if name != extname.upper():
                continue
        if all(c in data for c in required_cols):
            return hdu
    return None


def load_boss_spec(path_or_bytes):
    """Read one BOSS ``spec`` file.

    Returns a dict with ``lam_obs`` [Angstrom], ``flux``, ``ivar`` (bad
    pixels — AND_MASK != 0 or non-finite — zeroed), and when the SPALL HDU
    is present ``z``, ``zwarning``, ``class_``.  The dict plugs directly
    into ``quasar.preprocess.resample_to_rest`` / ``build_training_matrix``.
    """
    hdus = read_fits(path_or_bytes)
    coadd = (_find_bintable(hdus, ("FLUX", "LOGLAM", "IVAR"), extname="COADD")
             or _find_bintable(hdus, ("FLUX", "LOGLAM", "IVAR")))
    if coadd is None:
        raise ValueError("no COADD bintable with FLUX/LOGLAM/IVAR found")
    d = coadd["data"]
    lam_obs = np.power(10.0, np.asarray(d["LOGLAM"], np.float64))
    flux = np.asarray(d["FLUX"], np.float64)
    ivar = np.asarray(d["IVAR"], np.float64).copy()
    if "AND_MASK" in d:
        ivar[np.asarray(d["AND_MASK"]) != 0] = 0.0
    bad = ~(np.isfinite(flux) & np.isfinite(ivar))
    ivar[bad] = 0.0
    flux = np.where(np.isfinite(flux), flux, 0.0)
    out = {"lam_obs": lam_obs, "flux": flux, "ivar": ivar}

    spall = _find_bintable(hdus, ("Z",), extname="SPALL") \
        or _find_bintable(hdus, ("Z", "ZWARNING"))
    if spall is not None:
        s = spall["data"]
        out["z"] = float(np.asarray(s["Z"]).ravel()[0])
        if "ZWARNING" in s:
            out["zwarning"] = int(np.asarray(s["ZWARNING"]).ravel()[0])
        if "CLASS" in s:
            out["class_"] = str(np.asarray(s["CLASS"]).ravel()[0])
    return out
