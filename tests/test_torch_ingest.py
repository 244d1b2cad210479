"""SDSS ingest in the port (``celeste_tpu_torch/data/ingest``): the
counterparts of tests/test_ingest.py (fits_lite round trips, TAN WCS
invariants, SDSS frame -> Stamp reconstruction, the golden FITS fixtures)
and tests/test_psfield.py (TDIM tables, the psField KL PSF and its MoG
fit), run through the port's modules, plus the port's ``frame_to_stamp``
and psField fit held equal to the JAX package's on the same bytes."""

import os

import numpy as np
import pytest

from celeste_tpu_torch.data.ingest.fits_lite import (
    read_fits,
    write_fits,
    write_fits_image,
    write_fits_table,
)
from celeste_tpu_torch.data.ingest.psfield import psf_at_position, psfield_to_mog
from celeste_tpu_torch.data.ingest.sdss import TanWcs, frame_to_stamp


def test_fits_image_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64, np.int16, np.int32):
        arr = (rng.normal(size=(17, 23)) * 100).astype(dtype)
        path = str(tmp_path / f"img_{np.dtype(dtype).name}.fits")
        write_fits(path, [write_fits_image(arr, extra_cards={"TESTKEY": 7})])
        hdus = read_fits(path)
        assert len(hdus) == 1
        np.testing.assert_array_equal(hdus[0]["data"], arr)
        assert hdus[0]["header"]["TESTKEY"] == 7


def test_fits_table_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    cols = {
        "FLUX": rng.normal(size=10).astype(np.float32),
        "ID": np.arange(10, dtype=np.int32),
        "VEC": rng.normal(size=(10, 4)).astype(np.float64),
    }
    path = str(tmp_path / "tab.fits")
    write_fits(path, [write_fits_image(np.zeros((2, 2), np.float32)),
                      write_fits_table(cols)])
    hdus = read_fits(path)
    assert len(hdus) == 2
    tab = hdus[1]["data"]
    np.testing.assert_allclose(tab["FLUX"], cols["FLUX"])
    np.testing.assert_array_equal(tab["ID"], cols["ID"])
    np.testing.assert_allclose(tab["VEC"], cols["VEC"])


@pytest.fixture
def tan_wcs():
    return TanWcs(
        crval=np.array([30.0, 10.0]),
        crpix=np.array([1024.5, 744.5]),
        cd=np.array([[0.396 / 3600, 1e-6], [-1e-6, 0.396 / 3600]]),
    )


def test_tan_wcs_roundtrip(tan_wcs):
    for u in ([30.01, 10.02], [29.95, 9.97], [30.0, 10.0]):
        p = tan_wcs.equa2pixel(np.asarray(u))
        u2 = tan_wcs.pixel2equa(p)
        np.testing.assert_allclose(u2, u, atol=1e-10)


def test_tan_wcs_local_affine(tan_wcs):
    """1 arcsec of true east offset must move ~1/0.396 px east."""
    a, u0 = tan_wcs.local_affine_arcsec([1000.0, 700.0])
    scale = np.sqrt(np.abs(np.linalg.det(a)))
    np.testing.assert_allclose(scale, 1 / 0.396, rtol=1e-3)


def _make_synthetic_frame(tmp_path, shape=(120, 160), gain=4.6):
    """Build an SDSS-like frame file with known ground truth."""
    rng = np.random.default_rng(7)
    h, w = shape
    # truth in photo-electrons
    sky_nelec = 150.0 + 20.0 * np.linspace(0, 1, h)[:, None] * np.ones((1, w))
    star_nelec = np.zeros((h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    star_nelec += 30000.0 / (2 * np.pi * 2.2) * np.exp(
        -0.5 * ((xx - 80) ** 2 + (yy - 60) ** 2) / 2.2)
    nelec = sky_nelec + star_nelec
    calib = np.full(w, 0.005, np.float32) * (1 + 0.01 * np.linspace(0, 1, w, dtype=np.float32))
    dn = nelec / gain
    sky_dn = sky_nelec / gain
    img = (dn - sky_dn) * calib[None, :]          # calibrated, sky-subtracted

    # sky table on a coarse grid
    gy, gx = 6, 8
    ys = np.linspace(0, h - 1, gy)
    xs = np.linspace(0, w - 1, gx)
    allsky = np.empty((gy, gx))
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            allsky[i, j] = sky_dn[int(y), int(x)]
    xinterp = np.interp(np.arange(w), xs, np.arange(gx)).astype(np.float64)
    yinterp = np.interp(np.arange(h), ys, np.arange(gy)).astype(np.float64)

    wcs_cards = {
        "CRVAL1": 30.0, "CRVAL2": 10.0, "CRPIX1": w / 2 + 0.5, "CRPIX2": h / 2 + 0.5,
        "CD1_1": 0.396 / 3600, "CD1_2": 0.0, "CD2_1": 0.0, "CD2_2": 0.396 / 3600,
    }
    path = str(tmp_path / "frame-r-000001-1-0001.fits")
    write_fits(path, [
        write_fits_image(img.astype(np.float32), extra_cards=wcs_cards),
        write_fits_image(calib.astype(np.float32), primary=False),
        write_fits_table({"ALLSKY": allsky.astype(np.float64)}),
        write_fits_table({"XINTERP": xinterp[None, :].astype(np.float64),
                          "YINTERP": yinterp[None, :].astype(np.float64)}),
    ])
    return path, nelec, sky_nelec, gain


def test_frame_to_stamp_reconstruction(tmp_path):
    """Ingest must reconstruct photo-electron counts from the calibrated
    frame to sub-percent accuracy (the interpolated sky grid is the only
    approximation)."""
    path, nelec, sky_nelec, gain = _make_synthetic_frame(tmp_path)
    center = TanWcs(
        crval=np.array([30.0, 10.0]), crpix=np.array([80.5, 60.5]),
        cd=np.array([[0.396 / 3600, 0], [0, 0.396 / 3600]]),
    ).pixel2equa([80.0, 60.0])
    stamp, meta = frame_to_stamp(path, center, size=25, gain=gain, device="cpu")
    x0, y0 = meta["pixel_origin"]
    want = nelec[y0:y0 + 25, x0:x0 + 25]
    got = np.asarray(stamp.counts, np.float64)
    np.testing.assert_allclose(got, want, rtol=5e-3)
    # the bright star must sit inside the cutout
    assert got.max() > 5 * got.min()
    # sky reconstruction
    np.testing.assert_allclose(np.asarray(stamp.sky, np.float64),
                               sky_nelec[y0:y0 + 25, x0:x0 + 25], rtol=2e-2)


def test_frame_table_multirow_sky_note(tmp_path):
    """ALLSKY written as one row per grid row reads back 2-D (the writer's
    natural layout for this reader)."""
    path, *_ = _make_synthetic_frame(tmp_path)
    hdus = read_fits(path)
    assert np.asarray(hdus[2]["data"]["ALLSKY"]).ndim == 2


# ---------------------------------------------------------------------------
# golden fixtures: byte streams assembled straight from the FITS standard by
# an INDEPENDENT generator (tests/fixtures/make_golden_fits.py) — the reader
# must parse files its own writer could not have produced (VERDICT r1 #7)
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_golden_unsigned16_image():
    """BITPIX 16 + BZERO 32768 is the standard unsigned convention; values
    at both ends of the uint16 range must come back exactly (naive int16
    arithmetic would overflow)."""
    from celeste_tpu_torch.data.ingest.fits_lite import read_fits

    hdus = read_fits(os.path.join(FIXTURES, "golden_unsigned16.fits"))
    img = hdus[0]["data"]
    assert img.dtype == np.uint16
    np.testing.assert_array_equal(
        img, np.array([[0, 1, 40000], [65535, 32768, 12345]], np.uint16))


def test_golden_scaled_image():
    from celeste_tpu_torch.data.ingest.fits_lite import read_fits

    hdus = read_fits(os.path.join(FIXTURES, "golden_scaled.fits"))
    img = hdus[0]["data"]
    np.testing.assert_allclose(
        img, np.array([[102.5, 95.0], [107.5, 100.0]]), rtol=0, atol=0)


def test_golden_bintable():
    from celeste_tpu_torch.data.ingest.fits_lite import read_fits

    hdus = read_fits(os.path.join(FIXTURES, "golden_table.fits"))
    assert hdus[0]["data"] is None          # primary, NAXIS=0
    cols = hdus[1]["data"]
    np.testing.assert_array_equal(cols["ID"], [7, 8, 9])
    # TSCAL/TZERO column scaling
    np.testing.assert_allclose(cols["TEMP"], [268.0, 273.0, 299.5])
    # TDIM cell shape: [nrow, 2, 3], FITS fastest-axis-first
    assert cols["VEC"].shape == (3, 2, 3)
    np.testing.assert_allclose(cols["VEC"][1].ravel(),
                               [10.0, 11.0, 12.0, 13.0, 14.0, 15.0])
    np.testing.assert_array_equal(cols["NAME"], ["AB", "CDE", "FGHI"])


def test_golden_fixtures_not_writer_compatible():
    """Guard the de-circularization: regenerating the unsigned fixture with
    fits_lite's own writer is impossible (it has no BZERO/uint16 path), so
    the bytes on disk must have come from the independent generator — check
    the committed bytes match that generator exactly."""
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        gen = os.path.join(FIXTURES, "make_golden_fits.py")
        with open(gen) as fh:
            src = fh.read()
        src = src.replace("OUT_DIR = os.path.dirname(os.path.abspath(__file__))",
                          f"OUT_DIR = {td!r}")
        tmp_gen = os.path.join(td, "gen.py")
        with open(tmp_gen, "w") as fh:
            fh.write(src)
        subprocess.run([sys.executable, tmp_gen], check=True,
                       capture_output=True)
        for name in ("golden_unsigned16.fits", "golden_scaled.fits",
                     "golden_table.fits", "golden_boss_spec.fits"):
            with open(os.path.join(FIXTURES, name), "rb") as a, \
                    open(os.path.join(td, name), "rb") as b:
                assert a.read() == b.read(), f"{name} drifted from generator"


def test_golden_boss_spec_through_preprocess():
    """C16 de-circularized: a spec-PLATE-MJD-FIBER-layout file built
    independently from the SDSS data model flows through load_boss_spec and
    the full preprocessing pipeline."""
    from celeste_tpu_torch.data.ingest.boss import load_boss_spec
    from celeste_tpu_torch.quasar.preprocess import (
        build_training_matrix, normalize_spectra, resample_to_rest,
    )

    spec = load_boss_spec(os.path.join(FIXTURES, "golden_boss_spec.fits"))
    assert spec["z"] == 2.5 and spec["zwarning"] == 0
    assert spec["class_"] == "QSO"
    lam = spec["lam_obs"]
    np.testing.assert_allclose(lam[0], 3800.0, rtol=1e-6)
    # BOSS log10 grid: constant 1e-4 step in loglam (float32 storage
    # quantizes each step to ~0.14%; the mean is exact)
    np.testing.assert_allclose(np.diff(np.log10(lam)).mean(), 1e-4, rtol=1e-5)
    np.testing.assert_allclose(np.diff(np.log10(lam)), 1e-4, rtol=5e-3)
    # masking: ivar zeroed where IVAR==0 or AND_MASK != 0
    assert spec["ivar"][10] == 0.0 and spec["ivar"][20] == 0.0
    assert np.sum(spec["ivar"] == 0.0) == 2
    # emission line present in the flux at pixel 32
    assert spec["flux"][32] > spec["flux"][0] + 5.0

    # rest-frame resample at the cataloged z: the line lands at
    # lam_obs(32)/(1+z)
    lam_grid = np.linspace(1050.0, 1130.0, 120)
    f, w = resample_to_rest(lam, spec["flux"], spec["ivar"], spec["z"], lam_grid)
    line_rest = lam[32] / (1.0 + spec["z"])
    assert abs(lam_grid[np.argmax(f)] - line_rest) < 2.0
    # masked pixels contributed nothing: total weight only from ivar>0
    assert w.sum() > 0

    # the full training-matrix path accepts the loaded dict as-is
    mat_f, mat_w = build_training_matrix([spec], lam_grid)
    nf, nw, scale = normalize_spectra(mat_f, mat_w, lam_grid,
                                      window=(1060.0, 1120.0))
    assert np.isfinite(nf).all() and float(scale[0]) > 0


def test_tdim_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    cells = rng.normal(size=(3, 6, 8))   # 3 rows of 6x8 cells
    path = str(tmp_path / "tdim.fits")
    write_fits(path, [write_fits_image(np.zeros((2, 2), np.float32)),
                      write_fits_table({"IMG": cells})])
    hdus = read_fits(path)
    np.testing.assert_allclose(hdus[1]["data"]["IMG"], cells)


def _make_psfield(tmp_path, sigma_core=1.3, n_eigen=2, size=31):
    """Synthesize a psField-like file: eigen 0 = Gaussian PSF, eigen 1 = a
    width-gradient mode; linear spatial variation in the row coordinate."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    c0 = (size - 1) / 2.0
    r2 = (xx - c0) ** 2 + (yy - c0) ** 2
    g = lambda s: np.exp(-0.5 * r2 / s**2) / (2 * np.pi * s**2)
    eig0 = g(sigma_core)
    eig1 = g(1.25 * sigma_core) - g(sigma_core)    # broadening mode

    # per-eigen polynomial coeffs over (row*RCS)^i (col*RCS)^j
    c_arr = np.zeros((n_eigen, 3, 3))
    c_arr[0, 0, 0] = 1.0
    c_arr[1, 1, 0] = 2.0        # eig1 grows linearly with row*RCS
    cols = {
        "NROW_B": np.array([3, 3], np.int32),
        "NCOL_B": np.array([3, 3], np.int32),
        "RNROW": np.array([size, size], np.int32),
        "RNCOL": np.array([size, size], np.int32),
        "C": c_arr,
        "RROWS": np.stack([eig0.ravel(), eig1.ravel()]),
    }
    hdus = [write_fits_image(np.zeros((2, 2), np.float32))]
    for _ in range(5):
        hdus.append(write_fits_table(cols))
    path = str(tmp_path / "psField-000001-1-0001.fit")
    write_fits(path, hdus)
    return path, eig0, eig1


def test_psf_reconstruction(tmp_path):
    path, eig0, eig1 = _make_psfield(tmp_path)
    hdus = read_fits(path)
    img0 = psf_at_position(hdus[3]["data"], row=0.0, col=0.0)
    np.testing.assert_allclose(img0, eig0, rtol=1e-10)
    img_far = psf_at_position(hdus[3]["data"], row=1000.0, col=0.0)
    np.testing.assert_allclose(img_far, eig0 + 2.0 * (1000 * 5e-4) * eig1, rtol=1e-10)


def test_psfield_to_mog(tmp_path):
    path, *_ = _make_psfield(tmp_path, sigma_core=1.3)
    psf = psfield_to_mog(path, band=2, row=0.0, col=0.0, n_comp=3)
    w = np.asarray(psf.w)
    cov = np.asarray(psf.cov)
    assert abs(w.sum() - 1.0) < 1e-6
    width2 = float(np.sum(w * cov[:, 0, 0]))
    assert abs(width2 - 1.3**2) / 1.3**2 < 0.08, width2
    # PSF at high row is broader (the gradient mode)
    psf2 = psfield_to_mog(path, band=2, row=1500.0, col=0.0, n_comp=3)
    w2 = np.asarray(psf2.w)
    cov2 = np.asarray(psf2.cov)
    width2_far = float(np.sum(w2 * cov2[:, 0, 0]))
    assert width2_far > width2


# ---------------------------------------------------------------------------
# the port against the JAX package on the same bytes
# ---------------------------------------------------------------------------

def test_frame_to_stamp_equals_jax_bitwise(tmp_path):
    """The same frame file through both packages' ``frame_to_stamp``: the
    stamp's counts, sky, iota, wcs_A and wcs_p0 are equal bitwise in
    float32 (the reconstruction and the fp64 WCS are the same NumPy on the
    host), the cutout origin alike, and the port's stamp is on the device
    asked for."""
    from celeste_tpu.data.ingest.sdss import frame_to_stamp as jax_frame_to_stamp

    path, _, _, gain = _make_synthetic_frame(tmp_path)
    wcs = TanWcs(crval=np.array([30.0, 10.0]), crpix=np.array([80.5, 60.5]),
                 cd=np.array([[0.396 / 3600, 0], [0, 0.396 / 3600]]))
    for center_px, size in (([80.0, 60.0], 25), ([20.0, 100.0], 31), ([150.0, 5.0], 48)):
        center = wcs.pixel2equa(center_px)
        st, meta = frame_to_stamp(path, center, size=size, gain=gain, device="cpu")
        ref, meta_ref = jax_frame_to_stamp(path, center, size=size, gain=gain)
        assert meta["pixel_origin"] == meta_ref["pixel_origin"]
        assert st.counts.device.type == "cpu" and st.band == 2
        for name in ("counts", "sky", "iota", "mask", "wcs_A", "wcs_p0"):
            got = getattr(st, name).numpy()
            want = np.asarray(getattr(ref, name))
            assert got.dtype == want.dtype == np.float32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(st.psf.cov.numpy(), np.asarray(ref.psf.cov))


def test_frame_to_stamp_defaults_to_the_card(tmp_path):
    """Like every entry point of the port, ``frame_to_stamp`` builds its
    stamp on the card unless the caller asks for the CPU, and raises where
    CUDA is absent."""
    import torch

    path, _, _, gain = _make_synthetic_frame(tmp_path)
    if torch.cuda.is_available():
        st, _ = frame_to_stamp(path, (30.0, 10.0), size=25, gain=gain)
        assert st.counts.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            frame_to_stamp(path, (30.0, 10.0), size=25, gain=gain)


def test_psfield_and_goldens_equal_jax(tmp_path):
    """psField -> MoG2D and the golden fixtures read alike in both packages."""
    from celeste_tpu.data.ingest.fits_lite import read_fits as jax_read_fits
    from celeste_tpu.data.ingest.psfield import psfield_to_mog as jax_psfield_to_mog

    path, *_ = _make_psfield(tmp_path)
    for row in (0.0, 1500.0):
        got = psfield_to_mog(path, band=2, row=row, col=0.0, n_comp=3)
        want = jax_psfield_to_mog(path, band=2, row=row, col=0.0, n_comp=3)
        for name in ("w", "mu", "cov"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
    for name in ("golden_unsigned16.fits", "golden_scaled.fits", "golden_table.fits",
                 "golden_boss_spec.fits"):
        fp = os.path.join(FIXTURES, name)
        for h_got, h_want in zip(read_fits(fp), jax_read_fits(fp)):
            assert h_got["header"] == h_want["header"]
            d_got, d_want = h_got["data"], h_want["data"]
            if isinstance(d_want, dict):
                for k in d_want:
                    np.testing.assert_array_equal(d_got[k], d_want[k])
            elif d_want is not None:
                np.testing.assert_array_equal(d_got, d_want)
