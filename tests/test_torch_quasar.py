"""The port's quasar photo-z (``celeste_tpu_torch.quasar``, ``oracle.photoz``)
against the JAX package's, on the CPU.

Tolerances:
- the shipped basis, the filter bank, the synthetic templates and the
  preprocessing copies: exactly equal (NumPy in both packages);
- ``interp`` against ``jnp.interp``, on knots, between them and outside,
  rtol 1e-6, atol 1e-7; ``basis_band_matrix`` rtol 1e-5, atol 1e-7 x max,
  with queries exactly on the basis's knots; the 8192-point grid table
  rtol 1e-5, atol 1e-7 x max; the grid projection on and one ulp beside
  the grid's knots, with JAX's table, rtol 1e-5;
- ``make_photo_z_logdensity`` on 64 posterior-typical vectors and at
  |zeta| = 30: values rtol 1e-5; gradients rtol 3e-4, atol 1e-4.  Both
  packages' float32 gradients sit up to 3e-4 from a float64 evaluation of
  the same density there (measured), so 1e-4 would gate rounding.  The
  grid path's z-gradient is held against JAX's own grid path run in
  float64 on JAX's table (rtol 3e-4, atol 1e-4): JAX's float32 form
  (1 - f) T0 + f T1 cancels in that derivative, to a relative 1.16e-3 of
  the float64 reading on the test's vectors (measured; gated at rtol 3e-3,
  atol 1e-4), where the port's T0 + f (T1 - T0) stays within 7.4e-5; the
  port's form in float64 equals JAX's in float64 to rtol 1e-9;
- the NumPy oracle's log posterior against the port's, rtol 1e-5;
- the JAX package's gates in distribution at its sizes or smaller, and the
  segment, deadline and batch-size invariances bitwise;
- the port's tempered slice ladder against ``oracle_photoz_pt`` on two
  targets at the same ladder and steps: the gaps between their cold-chain
  z medians and interquartile ranges no larger than JAX's own gaps to the
  oracle on the same targets x 1.5 + 0.05.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.quasar import basis as jb, filters as jf, photometry as jp, photo_z as jz
from celeste_tpu.quasar import preprocess as jpre

from celeste_tpu_torch.inference.hmc import value_and_grad
from celeste_tpu_torch.interop import (
    band_matrix_grid_from_numpy,
    filterbank_from_numpy,
    quasar_basis_from_numpy,
)
from celeste_tpu_torch.oracle.photoz import (
    geometric_betas,
    oracle_photoz_logprob,
    oracle_photoz_pt,
)
from celeste_tpu_torch.quasar import basis as tb, filters as tf_, photometry as tp, photo_z as tz
from celeste_tpu_torch.quasar import preprocess as tpre

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

VAL_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=1e-4)
Z_GRAD32_TOL = dict(rtol=3e-3, atol=1e-4)


@pytest.fixture(scope="module")
def both():
    """(JAX basis, JAX filters, port basis, port filters): the JAX tests'
    512-point templates and 64-point filter grids, carried across as NumPy."""
    jbasis = jb.synthetic_template_basis(n_grid=512)
    jfilt = jf.sdss_like_filterbank(n_pts=64)
    basis = quasar_basis_from_numpy(np.asarray(jbasis.lam_rest), np.asarray(jbasis.b))
    filt = filterbank_from_numpy(np.asarray(jfilt.lam), np.asarray(jfilt.resp),
                                 np.asarray(jfilt.dlam), jfilt.names)
    return jbasis, jfilt, basis, filt


@pytest.fixture(scope="module")
def jax_grid(both):
    jbasis, jfilt, _, _ = both
    g = jp.band_matrix_grid(jbasis, jfilt, z_max=6.0, n_z=8192)
    return g, band_matrix_grid_from_numpy(np.asarray(g.table), g.z_max, g.n_basis)


def _target(basis, filt, w, m, z, frac, seed):
    """Fluxes of one target at (w, m, z) with ``frac`` photometric errors."""
    f = tp.project_to_bands(basis, filt, torch.tensor(w, dtype=torch.float32), m, z).numpy()
    e = frac * np.abs(f) + 1e-5
    return f + np.random.default_rng(seed).normal(size=f.shape) * e, e


def test_default_basis_is_the_jax_file():
    jpath = os.path.join(os.path.dirname(jb.__file__), "artifacts", "default_basis.npz")
    assert open(tb.DEFAULT_BASIS, "rb").read() == open(jpath, "rb").read()
    jd, td = jb.QuasarBasis.default(), tb.QuasarBasis.default()
    np.testing.assert_array_equal(td.lam_rest.numpy(), np.asarray(jd.lam_rest))
    np.testing.assert_array_equal(td.b.numpy(), np.asarray(jd.b))


def test_filterbank_and_templates_equal_jax():
    for n_pts in (64, 128):
        j, t = jf.sdss_like_filterbank(n_pts), tf_.sdss_like_filterbank(n_pts)
        assert t.names == j.names
        for name in ("lam", "resp", "dlam"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        w = (t.resp * t.lam * t.dlam).sum(1).numpy()
        np.testing.assert_allclose(w, 1.0, rtol=1e-5)
    j, t = jb.synthetic_template_basis(n_grid=512), tb.synthetic_template_basis(n_grid=512)
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    np.testing.assert_array_equal(t.lam_rest.numpy(), np.asarray(j.lam_rest))


def test_interp_matches_jnp_interp_on_and_between_knots():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(1.0, 10.0, 40)).astype(np.float32)
    fp = rng.normal(size=(3, 40)).astype(np.float32)
    x = np.concatenate([xp, xp[:-1] + 0.37 * np.diff(xp), [0.5, xp[0], xp[-1], 11.0],
                        rng.uniform(0.0, 11.0, 50)]).astype(np.float32)
    want = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(row),
                                           left=0.0, right=0.0)) for row in fp])
    got = tp.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the gradient in x is the segment's slope (JAX's, at points inside a segment)
    xq = torch.as_tensor(xp[:-1] + 0.37 * np.diff(xp)).requires_grad_(True)
    (g,) = torch.autograd.grad(tp.interp(xq, torch.as_tensor(xp), torch.as_tensor(fp[0])).sum(),
                               xq)
    jg = jax.grad(lambda q: jnp.sum(jnp.interp(q, jnp.asarray(xp), jnp.asarray(fp[0]))))(
        jnp.asarray(xq.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_basis_band_matrix_matches_jax(both):
    jbasis, jfilt, basis, filt = both
    for z in (0.0, 0.37, 1.7, 2.4, 4.1, 5.99):
        want = np.asarray(jp.basis_band_matrix(jbasis, jfilt, z))
        got = tp.basis_band_matrix(basis, filt, z).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())
    # queries exactly on the basis's knots: a basis whose grid holds every
    # filter wavelength, at z = 0
    lam = np.unique(np.concatenate([np.asarray(jfilt.lam).ravel(),
                                    np.geomspace(80.0, 1100.0, 300)]).astype(np.float32))
    b = np.abs(np.random.default_rng(2).normal(size=(4, lam.size))).astype(np.float32)
    jknot = jb.QuasarBasis(lam_rest=jnp.asarray(lam), b=jnp.asarray(b))
    want = np.asarray(jp.basis_band_matrix(jknot, jfilt, 0.0))
    got = tp.basis_band_matrix(quasar_basis_from_numpy(lam, b), filt, 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())
    batch = tp.basis_band_matrix(basis, filt, torch.tensor([0.37, 1.7])).numpy()
    np.testing.assert_array_equal(batch[1], tp.basis_band_matrix(basis, filt, 1.7).numpy())


def test_band_matrix_grid_matches_jax(both, jax_grid):
    _, _, basis, filt = both
    grid = tp.band_matrix_grid(basis, filt, z_max=6.0, n_z=8192)
    want = np.asarray(jax_grid[0].table)
    assert grid.table.shape == want.shape == (8192, 5, 4)
    np.testing.assert_allclose(grid.table.numpy(), want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


def test_grid_projection_on_and_beside_knots(jax_grid):
    jgrid, grid = jax_grid
    dz = np.float32(6.0 / 8191)
    knots = (np.array([0, 1, 17, 4095, 8190, 8191]) * dz).astype(np.float32)
    z = np.concatenate([knots, np.nextafter(knots, np.float32(7)),
                        np.nextafter(knots, np.float32(-1))]).astype(np.float32)
    z = np.clip(z, 0, 6.0).astype(np.float32)
    w = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    want = np.asarray(jax.vmap(lambda zz: jp.project_to_bands_grid(jgrid, jnp.asarray(w), 2.0,
                                                                     zz))(jnp.asarray(z)))
    got = tp.project_to_bands_grid(grid, torch.as_tensor(w).expand(z.size, 4), 2.0,
                                   torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, want, **VAL_TOL)


def _vectors(rng, n=64):
    """Posterior-typical unconstrained vectors around the test target's truth
    (z 1.7, w (0.4, 0.3, 0.2, 0.1), m 2), with 0.05 jitter."""
    vec0 = np.concatenate([[np.log(1.7 / (6.0 - 1.7))], np.log(np.array([0.4, 0.3, 0.2]) / 0.1),
                           [np.log(2.0)]])
    return (vec0[None] + 0.05 * rng.normal(size=(n, vec0.size))).astype(np.float32)


@pytest.mark.parametrize("path", ["exact", "grid"])
def test_logdensity_value_and_gradient_match_jax(both, jax_grid, path):
    jbasis, jfilt, basis, filt = both
    flux, err = _target(basis, filt, [0.4, 0.3, 0.2, 0.1], 2.0, 1.7, 0.03, seed=7)
    n_grid = 0 if path == "exact" else 8192
    jl = jz.make_photo_z_logdensity(jbasis, jfilt, flux, err, jz.PhotoZConfig(flux_grid_n=n_grid))
    grid = jax_grid[1] if path == "grid" else None
    tl = tz.make_photo_z_logdensity(basis, filt, flux, err, tz.PhotoZConfig(flux_grid_n=n_grid),
                                    grid=grid)
    v = _vectors(np.random.default_rng(7))
    far = v[:4].copy()
    far[:, 0] = [30.0, 30.0, -30.0, -30.0]          # |zeta| = 30: z at 0 and at z_max
    v = np.concatenate([v, far])
    jv = np.asarray(jax.vmap(jl)(jnp.asarray(v)))
    jg = np.asarray(jax.vmap(jax.grad(jl))(jnp.asarray(v)))
    tv, tg = value_and_grad(tl, torch.as_tensor(v))
    assert np.isfinite(tv.numpy()).all() and np.isfinite(tg.numpy()).all()
    np.testing.assert_allclose(tv.numpy(), jv, **VAL_TOL)
    if path == "exact":
        np.testing.assert_allclose(tg.numpy(), jg, **GRAD_TOL)
        return
    np.testing.assert_allclose(tg.numpy()[:, 1:], jg[:, 1:], **GRAD_TOL)
    # the z-gradient against JAX's own grid path in float64 on JAX's table
    with jax.enable_x64(True):
        jgrid64 = jax_grid[0]._replace(table=jnp.asarray(np.asarray(jax_grid[0].table),
                                                         jnp.float64))
        jl64 = jz.make_photo_z_logdensity(jbasis, jfilt, flux, err, jz.PhotoZConfig(),
                                          grid=jgrid64)
        jg64 = np.asarray(jax.vmap(jax.grad(jl64))(jnp.asarray(v, jnp.float64)))
    assert jg64.dtype == np.float64
    np.testing.assert_allclose(tg.numpy()[:, 0], jg64[:, 0], **GRAD_TOL)
    # JAX's float32 z-gradient, whose (1 - f) T0 + f T1 cancels, within
    # Z_GRAD32_TOL of the same float64 reading (module docstring)
    np.testing.assert_allclose(jg[:, 0], jg64[:, 0], **Z_GRAD32_TOL)
    # the port's own form in float64 equals JAX's in float64 (rtol 1e-9)
    grid64 = grid._replace(table=grid.table.double())
    basis64 = tb.QuasarBasis(basis.lam_rest.double(), basis.b.double())
    l64 = tz.make_photo_z_logdensity(basis64, filt, flux, err, tz.PhotoZConfig(), grid=grid64)
    x = torch.as_tensor(v, dtype=torch.float64).requires_grad_(True)
    (g64,) = torch.autograd.grad(l64(x).sum(), x)
    np.testing.assert_allclose(g64.numpy(), jg64, rtol=1e-9, atol=1e-9)


def test_oracle_logprob_matches_port(both):
    _, _, basis, filt = both
    flux, err = _target(basis, filt, [0.4, 0.3, 0.2, 0.1], 2.0, 1.7, 0.03, seed=11)
    logd = tz.make_photo_z_logdensity(basis, filt, flux, err, tz.PhotoZConfig(flux_grid_n=0))
    lam_rest, b = basis.lam_rest.double().numpy(), basis.b.double().numpy()
    fl = filt.lam.double().numpy()
    fw = (filt.resp * filt.lam * filt.dlam).double().numpy()
    rng = np.random.default_rng(11)
    v = rng.normal(0, 1.5, (20, 5)).astype(np.float32)
    got = logd(torch.as_tensor(v)).numpy()
    want = np.array([oracle_photoz_logprob(x.astype(np.float64), lam_rest, b, fl, fw, flux, err)
                     for x in v])
    np.testing.assert_allclose(got, want, **VAL_TOL)


def test_preprocess_equals_jax():
    lam_grid = np.geomspace(100, 900, 200)
    rng = np.random.default_rng(0)
    spectra = []
    for _ in range(6):
        lam_obs = np.linspace(360, 1000, 1500)
        spectra.append({"lam_obs": lam_obs, "flux": (lam_obs / 500) ** -1.0
                        + rng.normal(0, 0.01, 1500), "ivar": np.full(1500, 1e4),
                        "z": rng.uniform(0.5, 3.0)})
    for a, b in zip(tpre.build_training_matrix(spectra, lam_grid),
                    jpre.build_training_matrix(spectra, lam_grid)):
        np.testing.assert_array_equal(a, b)
    f, w = tpre.build_training_matrix(spectra, lam_grid)
    for a, b in zip(tpre.normalize_spectra(f, w, lam_grid), jpre.normalize_spectra(f, w, lam_grid)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpre.train_test_split(10, 0.2, 1), jpre.train_test_split(10, 0.2, 1)):
        np.testing.assert_array_equal(a, b)
    true_rest = lambda lam: (lam / 250.0) ** -1.2  # noqa: E731
    lam_obs = np.linspace(300, 2000, 4000)
    fg, wg = tpre.resample_to_rest(lam_obs, true_rest(lam_obs / 2.5), np.full(4000, 100.0), 1.5,
                                   np.geomspace(100, 900, 300))
    np.testing.assert_allclose(fg[wg > 0], true_rest(np.geomspace(100, 900, 300)[wg > 0]),
                               rtol=2e-2)


def test_fit_basis_recovers_subspace(both):
    _, _, basis, _ = both
    spectra, ivar, _, _ = tb.synthetic_quasar_spectra(64, basis, seed=1, snr=30.0)
    fitted, losses = tb.fit_basis(spectra, ivar, basis.lam_rest, n_basis=4, n_steps=1200, seed=0)
    assert float(losses[-1]) < float(losses[10])
    b, s = fitted.b.numpy(), spectra.numpy()
    coef, *_ = np.linalg.lstsq(b.T, s.T, rcond=None)
    chi = np.abs(s - (b.T @ coef).T) * np.sqrt(ivar.numpy())
    assert np.mean(chi) < 2.0, float(np.mean(chi))


def test_photo_z_recovers_redshift(both):
    """Config 4 end to end with the slice inner (the JAX gate, 150 steps
    where JAX takes 600, 2 systems where it takes 6)."""
    _, _, basis, filt = both
    flux, err = _target(basis, filt, [0.15, 0.1, 0.65, 0.1], 2.0, 2.4, 0.03, seed=3)
    cfg = tz.PhotoZConfig(n_temps=6, n_steps=150, n_warmup=50, n_systems=2)
    out = tz.run_photo_z(0, basis, filt, flux, err, cfg, device="cpu")
    z = out["z"].numpy().ravel()
    assert z.shape == (2 * 100,) and np.isfinite(z).all()
    assert np.mean(np.abs(z - 2.4) < 0.25) > 0.3
    assert float(out["swap_rate"]) > 0.05 and out["calls_per_sweep"] > 5


def test_photo_z_hmc_inner(both):
    _, _, basis, filt = both
    flux, err = _target(basis, filt, [0.3, 0.2, 0.3, 0.2], 1.4, 1.6, 0.03, seed=6)
    cfg = tz.PhotoZConfig(n_temps=6, n_steps=400, n_warmup=150, n_systems=4, inner="hmc")
    out = tz.run_photo_z(5, basis, filt, flux, err, cfg, device="cpu")
    z = out["z"].numpy().ravel()
    assert np.mean(np.abs(z - 1.6) < 0.3) > 0.3, np.percentile(z, [25, 50, 75])


def test_photo_z_logdensity_finite_and_needs_a_device(both):
    _, _, basis, filt = both
    logd = tz.make_photo_z_logdensity(basis, filt, np.array([1.0, 2.0, 3.0, 3.5, 4.0]) * 1e-3,
                                      np.full(5, 1e-4))
    val, grad = value_and_grad(logd, torch.zeros((1, 5)))
    assert np.isfinite(val.numpy()).all() and np.isfinite(grad.numpy()).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tz.run_photo_z(0, basis, filt, np.ones(5), np.ones(5), tz.PhotoZConfig(n_steps=2))


def _batch_targets(basis, filt, zs, seed):
    rng = np.random.default_rng(seed)
    flux, err = [], []
    for z in zs:
        f = tp.project_to_bands(basis, filt, torch.full((4,), 0.25), 2.0, float(z)).numpy()
        e = 0.03 * np.abs(f) + 1e-5
        flux.append(f + rng.normal(size=f.shape) * e)
        err.append(e)
    return np.stack(flux), np.stack(err)


def test_photo_z_batch_independent_targets(both):
    _, _, basis, filt = both
    flux, err = _batch_targets(basis, filt, (1.2, 3.1), seed=5)
    cfg = tz.PhotoZConfig(n_temps=5, n_steps=400, n_warmup=150, n_systems=2, inner="hmc_adaptive")
    out = tz.run_photo_z_batch(6, basis, filt, flux, err, cfg, device="cpu")
    z_med = np.median(out["z"].numpy().reshape(2, -1), axis=1)
    assert abs(z_med[0] - 1.2) < 0.35 and abs(z_med[1] - 3.1) < 0.35, z_med


def test_photo_z_batch_segmented_invariance(both):
    _, _, basis, filt = both
    flux, err = _batch_targets(basis, filt, (1.0, 2.8), seed=9)
    cfg = tz.PhotoZConfig(n_temps=4, n_steps=24, n_warmup=6, n_systems=1, inner="hmc_adaptive",
                          pt_warmup_steps=15)
    mono = tz.run_photo_z_batch_segmented(3, basis, filt, flux, err, cfg, segment_steps=24,
                                          device="cpu")
    seg = tz.run_photo_z_batch_segmented(3, basis, filt, flux, err, cfg, segment_steps=7,
                                         device="cpu")
    assert torch.equal(mono["vec"], seg["vec"])
    assert mono["z"].shape == (2, 1, 18) and bool(torch.isfinite(mono["z"]).all())
    assert len(seg["timings"]["segment_s"]) == 4


def test_photo_z_batch_segmented_slice_invariance(both):
    """The slice inner's one stream keeps segment boundaries invisible too."""
    _, _, basis, filt = both
    flux, err = _batch_targets(basis, filt, (1.0, 2.8), seed=9)
    cfg = tz.PhotoZConfig(n_temps=3, n_steps=8, n_warmup=2, n_systems=1)
    mono = tz.run_photo_z_batch_segmented(3, basis, filt, flux, err, cfg, segment_steps=8,
                                          device="cpu")
    seg = tz.run_photo_z_batch_segmented(3, basis, filt, flux, err, cfg, segment_steps=3,
                                         device="cpu")
    assert torch.equal(mono["vec"], seg["vec"])


def test_photo_z_batch_segmented_deadline_stop(both):
    _, _, basis, filt = both
    flux, err = _batch_targets(basis, filt, (1.5,), seed=5)
    cfg = tz.PhotoZConfig(n_temps=4, n_steps=21, n_warmup=3, n_systems=1, inner="hmc_adaptive",
                          pt_warmup_steps=10)
    full = tz.run_photo_z_batch_segmented(4, basis, filt, flux, err, cfg, segment_steps=7,
                                          device="cpu")
    cut = tz.run_photo_z_batch_segmented(4, basis, filt, flux, err, cfg, segment_steps=7,
                                         deadline_fn=lambda: False, device="cpu")
    assert full["n_steps_done"] == 21 and cut["n_steps_done"] == 7
    assert len(cut["timings"]["segment_s"]) == 1
    assert torch.equal(full["vec"][:, :, :7 - cfg.n_warmup], cut["vec"])
    assert bool(torch.isfinite(cut["z"]).all())


@pytest.mark.parametrize("inner", ["hmc_adaptive", "hmc"])
def test_photo_z_batch_size_invariance(both, inner):
    """Each target draws from its own streams: its chain is bitwise the
    same in a batch of 6 or of 3."""
    _, _, basis, filt = both
    flux, err = _batch_targets(basis, filt, (0.8, 1.9, 3.0, 1.4, 2.5, 3.6), seed=11)
    cfg = tz.PhotoZConfig(n_temps=4, n_steps=20, n_warmup=5, n_systems=1, inner=inner,
                          pt_warmup_steps=10)
    big = tz.run_photo_z_batch_segmented(2, basis, filt, flux, err, cfg, device="cpu")
    sub = tz.run_photo_z_batch_segmented(2, basis, filt, flux[:3], err[:3], cfg, device="cpu")
    assert torch.equal(big["vec"][:3], sub["vec"])


def test_quasar_photoz_entry_point():
    """``run_experiment`` of config 4 with JAX's scene recipe, cut in steps."""
    from celeste_tpu_torch.run import main

    res = main(["config=quasar_photoz", "device=cpu", "n_chains=2", "n_temps=4",
                "n_steps=30", "n_warmup=10"])
    assert res["z"].shape == (2, 20) and np.isfinite(res["z"]).all()
    rng = np.random.default_rng(0)
    assert res["z_true"] == rng.uniform(0.5, 4.0)
    assert 0.0 <= res["swap_rate"] <= 1.0 and res["calls_per_sweep"] > 0


def _median_iqr(z):
    q25, q50, q75 = np.percentile(z, [25, 50, 75])
    return np.array([q50, q75 - q25])


def test_tempered_slice_against_the_oracle_sampler(both):
    """The gate the JAX package never got: the port's tempered slice ladder
    and ``oracle_photoz_pt`` on two targets at the same ladder (4
    temperatures, beta_min 0.02) and steps (120, 40 burned; two systems
    in both packages, one oracle ladder): the port's gap to the oracle in
    cold-chain z median and IQR is at most JAX's own gap on the same
    targets x 1.5 + 0.05."""
    jbasis, jfilt, basis, filt = both
    flux, err = _batch_targets(basis, filt, (1.2, 3.1), seed=21)
    n_steps, burn = 120, 40
    cfg = tz.PhotoZConfig(n_temps=4, n_steps=n_steps, n_warmup=burn, n_systems=2)
    jcfg = jz.PhotoZConfig(n_temps=4, n_steps=n_steps, n_warmup=burn, n_systems=2)
    jout = jz.run_photo_z_batch(jax.random.key(1), jbasis, jfilt, flux, err, jcfg)
    port = tz.run_photo_z_batch(1, basis, filt, flux, err, cfg, device="cpu")
    lam_rest, b = basis.lam_rest.double().numpy(), basis.b.double().numpy()
    fl, fw = filt.lam.double().numpy(), (filt.resp * filt.lam * filt.dlam).double().numpy()
    betas = geometric_betas(4, 0.02)
    for t in range(2):
        rng = np.random.default_rng(100 + t)
        lp = lambda v: oracle_photoz_logprob(v, lam_rest, b, fl, fw, flux[t], err[t])  # noqa: E731
        x0s = rng.normal(size=(4, 5)) * np.asarray([2.0, 1.0, 1.0, 1.0, 1.0])
        cold, _ = oracle_photoz_pt(lp, x0s, betas, n_steps, np.ones(5), rng)
        oracle = _median_iqr(6.0 / (1.0 + np.exp(-cold[burn:, 0])))
        gap_port = np.abs(_median_iqr(port["z"][t].numpy().ravel()) - oracle)
        gap_jax = np.abs(_median_iqr(np.asarray(jout["z"][t]).ravel()) - oracle)
        print(f"target {t}: oracle median, IQR {oracle}; gap port {gap_port}, JAX {gap_jax}")
        assert np.all(gap_port <= 1.5 * gap_jax + 0.05), (t, gap_port, gap_jax, oracle)
