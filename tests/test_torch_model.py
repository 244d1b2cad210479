"""The port's model layer (``celeste_tpu_torch.mog``, ``model``,
``likelihood``, ``data``, ``interop``) against the JAX package and the NumPy
oracle on identical inputs, on the CPU.

Tolerances: elementwise float32 algebra done in the same order in both
packages (precision form, convolution, bijections, priors) agrees to
rtol 1e-6 (an ulp or two); rendered lambda to rtol 1e-5, atol 1e-3 (as the
JAX package's render-kernel test); lambda against the fp64 oracle to
rtol 2e-4, atol 1e-3 (tests/test_forward_parity.py:45); log-likelihood sums
over ~625 pixels of magnitude ~1e3 to rtol 2e-6, atol 0.5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celeste_tpu import mog as jmog
from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp as j_make, star_source
from celeste_tpu.likelihood import stamp_loglik as j_stamp_loglik
from celeste_tpu.model import expected_image as j_expected_image
from celeste_tpu.model.params import GalaxyParams as JGalaxy, StarParams as JStar
from celeste_tpu.model.priors import SourcePriors as JPriors
from celeste_tpu.model.psf import fit_psf_mog as j_fit_psf_mog, sdss_like_psf as j_sdss_like_psf

from celeste_tpu_torch import mog as tmog
from celeste_tpu_torch.data.synthetic import make_synthetic_stamp as t_make
from celeste_tpu_torch.interop import (
    galaxy_params_from_numpy, hmc_warm_state_from_numpy, stamp_from_numpy,
    star_params_from_numpy,
)
from celeste_tpu_torch.likelihood import stamp_loglik as t_stamp_loglik
from celeste_tpu_torch.model import expected_image as t_expected_image
from celeste_tpu_torch.model.params import GalaxyParams as TGalaxy, StarParams as TStar
from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors as TPriors
from celeste_tpu_torch.model.psf import fit_psf_mog as t_fit_psf_mog, sdss_like_psf as t_sdss_like_psf
from celeste_tpu_torch.oracle.forward import oracle_galaxy_lambda, oracle_star_lambda

from torch_port_helpers import one_torch_thread, port_params, port_stamp  # noqa: F401 (autouse fixture)

EXACT = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _random_mog(rng, k):
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    mu = rng.normal(size=(k, 2)).astype(np.float32)
    a = rng.normal(size=(k, 2, 2))
    cov = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(2)).astype(np.float32)
    return w, mu, cov


@pytest.fixture(scope="module")
def scenes():
    star = star_source(u=(30.0001, 9.9999), flux_r=25.0)
    gal = galaxy_source(u=(30.0, 10.0), flux_r=60.0, theta_dev=0.35, sigma=1.8, ab=0.55,
                        phi=0.9)
    return {"star": j_make([star], shape=(25, 25), bands=(2,), seed=3),
            "galaxy": j_make([gal], shape=(31, 31), bands=(2,), seed=4)}


def test_precision_form_matches_jax():
    w, mu, cov = _random_mog(np.random.default_rng(0), 7)
    want = jmog.precision_form(jmog.MoG2D(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(cov)))
    got = tmog.precision_form(tmog.MoG2D(_t(w), _t(mu), _t(cov)))
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **EXACT)


def test_convolve_and_eval_grid_match_jax():
    rng = np.random.default_rng(1)
    f, g = _random_mog(rng, 4), _random_mog(rng, 3)
    jf, jg = (jmog.MoG2D(*map(jnp.asarray, m)) for m in (f, g))
    tf, tg = (tmog.MoG2D(*map(_t, m)) for m in (f, g))
    jc, tc = jmog.convolve(jf, jg), tmog.convolve(tf, tg)
    for name in ("w", "mu", "cov"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   **EXACT)
    px = rng.uniform(-3, 3, 50).astype(np.float32)
    py = rng.uniform(-3, 3, 50).astype(np.float32)
    np.testing.assert_allclose(tmog.eval_grid(tc, _t(px), _t(py)).numpy(),
                               np.asarray(jmog.eval_grid(jc, jnp.asarray(px), jnp.asarray(py))),
                               rtol=1e-5, atol=1e-7)


def _jax_params(src, wcs, kind):
    du = jnp.asarray(wcs.equa2duas(src["u"]), jnp.float32)
    flux = jnp.asarray(src["flux"], jnp.float32)
    if kind == "star":
        return JStar(u=du, flux=flux)
    return JGalaxy(u=du, flux=flux, theta_dev=jnp.float32(src["theta_dev"]),
                   sigma=jnp.float32(src["sigma"]), ab=jnp.float32(src["ab"]),
                   phi=jnp.float32(src["phi"]))


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_expected_image_matches_jax_and_oracle(scenes, kind):
    scene = scenes[kind]
    src = scene.sources[0]
    stamp = port_stamp(scene.stamps[0])
    got = t_expected_image([port_params(src, scene.wcs, kind)], stamp, band=2).numpy()
    want = np.asarray(j_expected_image([_jax_params(src, scene.wcs, kind)], scene.stamps[0],
                                       band=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    ost = scene.oracle_stamps[0]
    if kind == "star":
        lam = oracle_star_lambda(src["u"], src["flux"][2], ost)
    else:
        lam = oracle_galaxy_lambda(src["u"], src["flux"][2], src["theta_dev"], src["sigma"],
                                   src["ab"], src["phi"], ost)
    np.testing.assert_allclose(got, lam, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("normalized,centered", [(False, False), (True, False), (False, True)])
def test_stamp_loglik_matches_jax(scenes, normalized, centered):
    scene = scenes["star"]
    src = scene.sources[0]
    got = float(t_stamp_loglik([port_params(src, scene.wcs, "star")],
                               port_stamp(scene.stamps[0]), band=2,
                               normalized=normalized, centered=centered))
    want = float(j_stamp_loglik([_jax_params(src, scene.wcs, "star")], scene.stamps[0],
                                band=2, normalized=normalized, centered=centered))
    assert abs(got - want) <= 0.5 + 2e-6 * abs(want), (got, want)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_params_bijections_and_priors_match_jax(kind):
    rng = np.random.default_rng(2)
    d = 7 if kind == "star" else 11
    vec = (rng.normal(size=(6, d)) * 0.5 + 1.0).astype(np.float32)
    jcls, tcls = (JStar, TStar) if kind == "star" else (JGalaxy, TGalaxy)
    jp, tp = jcls.from_vector(jnp.asarray(vec), 5), tcls.from_vector(_t(vec), 5)
    fields = ("u", "flux") if kind == "star" else ("u", "flux", "theta_dev", "sigma", "ab",
                                                   "phi")
    for name in fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   **EXACT)
    np.testing.assert_allclose(tcls.log_det_jacobian(_t(vec), 5).numpy(),
                               np.asarray(jcls.log_det_jacobian(jnp.asarray(vec), 5)), **EXACT)
    np.testing.assert_allclose(tp.to_vector().numpy(), vec, rtol=1e-5, atol=1e-5)
    jpri, tpri = JPriors(), TPriors()
    if kind == "star":
        got, want = tpri.star_logpdf(tp), jpri.star_logpdf(jp)
    else:
        got, want = tpri.galaxy_logpdf(tp), jpri.galaxy_logpdf(jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_psf_models_match_jax():
    """``sdss_like_psf`` and the NumPy EM fit ``fit_psf_mog`` (copied) give
    the JAX package's arrays exactly."""
    for n_comp in (1, 2, 3):
        want, got = j_sdss_like_psf(n_comp=n_comp), t_sdss_like_psf(n_comp=n_comp)
        for name in ("w", "mu", "cov"):
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    yy, xx = np.mgrid[0:15, 0:15] - 7.0
    img = 0.7 * np.exp(-(xx**2 + yy**2) / 4.0) + 0.3 * np.exp(-(xx**2 + yy**2) / 18.0)
    want, got = j_fit_psf_mog(img, n_iter=50), t_fit_psf_mog(img, n_iter=50)
    for name in ("w", "mu", "cov"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_color_gmm_prior_is_not_silently_ignored():
    with pytest.raises(NotImplementedError):
        FluxPrior(color_gmm=object())


def test_synthetic_counts_bitwise_equal():
    srcs = [star_source(u=(30.0002, 10.0001), flux_r=25.0),
            galaxy_source(u=(29.9999, 9.9998), flux_r=40.0)]
    want = j_make(srcs, shape=(21, 23), bands=(1, 2, 3), seed=17)
    got = t_make(srcs, shape=(21, 23), bands=(1, 2, 3), seed=17)
    for js, ts in zip(want.stamps, got.stamps):
        assert np.array_equal(ts.counts.numpy(), np.asarray(js.counts))
        assert ts.band == int(js.band)
        for name in ("sky", "mask", "wcs_A", "wcs_p0"):
            assert np.array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
        for name in ("w", "mu", "cov"):
            assert np.array_equal(getattr(ts.psf, name).numpy(),
                                  np.asarray(getattr(js.psf, name)))


def test_interop_round_trip():
    rng = np.random.default_rng(3)
    arrays = dict(counts=rng.poisson(150.0, (5, 6)).astype(np.float32),
                  sky=np.full((5, 6), 150.0, np.float32), iota=np.float32(800.0),
                  mask=np.ones((5, 6), np.float32), psf_w=np.float32([0.8, 0.2]),
                  psf_mu=np.zeros((2, 2), np.float32),
                  psf_cov=np.stack([np.eye(2), 4 * np.eye(2)]).astype(np.float32),
                  wcs_A=np.float32([[2.5, 0.1], [-0.1, 2.5]]), wcs_p0=np.float32([2.0, 2.5]))
    st = stamp_from_numpy(**arrays, band=2)
    assert st.band == 2
    for name in ("counts", "sky", "iota", "mask", "wcs_A", "wcs_p0"):
        assert np.array_equal(getattr(st, name).numpy(), arrays[name])
    for name in ("w", "mu", "cov"):
        assert np.array_equal(getattr(st.psf, name).numpy(), arrays["psf_" + name])
    u, flux = np.float32([0.1, -0.2]), np.float32([1, 2, 3, 4, 5])
    sp = star_params_from_numpy(u, flux)
    assert np.array_equal(sp.u.numpy(), u) and np.array_equal(sp.flux.numpy(), flux)
    gp = galaxy_params_from_numpy(u, flux, 0.3, 1.5, 0.6, 0.7)
    np.testing.assert_array_equal(
        [gp.theta_dev.item(), gp.sigma.item(), gp.ab.item(), gp.phi.item()],
        np.float32([0.3, 1.5, 0.6, 0.7]))
    x = rng.normal(size=(4, 3)).astype(np.float32)
    state, eps, im = hmc_warm_state_from_numpy(x, x.sum(1), -x, np.float32([0.1] * 4),
                                               np.ones((4, 3), np.float32))
    assert np.array_equal(state.x.numpy(), x) and np.array_equal(state.grad.numpy(), -x)
    assert np.array_equal(state.logp.numpy(), x.sum(1))
    assert eps.shape == (4,) and im.shape == (4, 3)
