"""MAP fitting and peak detection of the port (``celeste_tpu_torch/
inference/map_fit.py``) against the JAX package's, on the same NumPy-seeded
inputs.

Tolerances: ``detect_peaks`` is NumPy in both packages, so peaks and SNRs
are bitwise equal; ``map_fit`` from one start lands within atol 2e-3 of
JAX's point (both are float32 Adam on the same posterior, the port's log
density summed in another order) with the log density within rtol 2e-6,
atol 1.0 (the stamp kernel gate of tests/test_pallas_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.inference import map_fit as jmf
from celeste_tpu.inference.problems import make_star_logdensity as j_star_logd
from celeste_tpu.model import expected_image
from celeste_tpu.model.params import StarParams as JStar
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors

from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene
from celeste_tpu_torch.inference import map_fit as tmf
from celeste_tpu_torch.inference.problems import make_star_logdensity as t_star_logd
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors

from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

MAP_X_ATOL = 2e-3
LOGP_TOL = dict(rtol=2e-6, atol=1.0)


@pytest.fixture(scope="module")
def pipeline_field():
    """The ``pipeline`` config's 33x33 field (two stars and a galaxy)."""
    scene, srcs = pipeline_scene(CONFIGS["pipeline"], "cpu")
    return make_synthetic_stamp(srcs, shape=(33, 33), bands=(2,), seed=101), scene, srcs


@pytest.fixture(scope="module")
def star_problem():
    src = star_source(u=(30.0001, 10.0002), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=4)
    mean = float(np.log(30.0))
    j = j_star_logd(scene.stamps, bands=[0], n_bands=1,
                    priors=JPriors(flux=JFlux(log_ref_mean=mean, log_ref_std=2.0)))
    t = t_star_logd([port_stamp(s) for s in scene.stamps], bands=[0], n_bands=1,
                    priors=TPriors(flux=TFlux(log_ref_mean=mean, log_ref_std=2.0)))
    truth = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])]])
    return scene, src, j, t, truth.astype(np.float32)


def _assert_peaks_equal(jstamp, tstamp, **kw):
    jp, js = jmf.detect_peaks(jstamp, **kw)
    tp, ts = tmf.detect_peaks(tstamp, **kw)
    assert jp.shape == tp.shape and js.shape == ts.shape
    assert np.array_equal(jp, tp) and np.array_equal(js, ts), (jp, tp, js, ts)
    return tp


def test_detect_peaks_bitwise_on_the_pipeline_field(pipeline_field):
    jscene, tscene, _ = pipeline_field
    # the port's scene is the JAX package's, bitwise
    assert np.array_equal(np.asarray(jscene.stamps[0].counts), tscene.stamps[0].counts.numpy())
    peaks = _assert_peaks_equal(jscene.stamps[0], tscene.stamps[0], n_peaks=4,
                                min_separation=7)
    assert len(peaks) == 4
    _assert_peaks_equal(jscene.stamps[0], tscene.stamps[0], n_peaks=6)


def test_detect_peaks_bitwise_on_a_clean_residual(pipeline_field):
    """The residual after subtracting the brighter star's true image, as
    the CLEAN loop hands it to detection (float32 counts)."""
    jscene, tscene, srcs = pipeline_field
    jst = jscene.stamps[0]
    p = JStar(u=jnp.asarray(jscene.wcs.equa2duas(srcs[0]["u"]), jnp.float32),
              flux=jnp.asarray(srcs[0]["flux"], jnp.float32))
    lam = np.asarray(expected_image([p], jst, band=2)) - np.asarray(jst.sky)
    resid = (np.asarray(jst.counts, np.float64) - lam).astype(np.float32)
    jres = jst.__class__(jnp.asarray(resid), jst.sky, jst.iota, jst.mask, jst.psf, jst.wcs_A,
                         jst.wcs_p0, jst.band)
    tst = tscene.stamps[0]
    tres = tst.__class__(torch.as_tensor(resid), tst.sky, tst.iota, tst.mask, tst.psf,
                         tst.wcs_A, tst.wcs_p0, tst.band)
    _assert_peaks_equal(jres, tres, n_peaks=3, min_separation=7)


def test_map_fit_matches_jax_from_the_same_start(star_problem):
    _, _, j_logd, t_logd, truth = star_problem
    rng = np.random.default_rng(5)
    x0 = (truth + np.array([0.3, -0.25, 0.4]) * rng.uniform(0.5, 1.0, 3)).astype(np.float32)
    jx, jtrace = jmf.map_fit(j_logd, jnp.asarray(x0), n_steps=200)
    tx, ttrace = tmf.map_fit(t_logd, torch.as_tensor(x0)[None], n_steps=200)
    assert ttrace.shape == (200, 1)
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), rtol=0, atol=MAP_X_ATOL)
    np.testing.assert_allclose(ttrace[:, 0].numpy(), np.asarray(jtrace), **LOGP_TOL)
    # the ascent climbed to the truth's neighbourhood
    assert float(ttrace[-1, 0]) > float(ttrace[0, 0])
    assert np.abs(tx[0].numpy() - truth).max() < 0.05


def test_map_fit_leaves_zero_gradient_coordinates_still(star_problem):
    """A coordinate the log density does not read keeps its start (the
    pipeline's padded star slots rely on it)."""
    _, _, _, t_logd, truth = star_problem
    x0 = torch.as_tensor(np.concatenate([truth, [1.25, -3.0]]).astype(np.float32))[None]
    x, _ = tmf.map_fit(lambda x: t_logd(x[:, :3]), x0, n_steps=20)
    assert torch.equal(x[0, 3:], x0[0, 3:])


def test_map_fit_batch_picks_the_same_restart(star_problem):
    """Four restarts at 40 steps, short enough that they end tens to
    thousands of nats apart: both packages keep the same one."""
    _, _, j_logd, t_logd, truth = star_problem
    off = np.array([[1.5, 1.5, -1.0], [0.6, -0.4, 0.5], [0.05, 0.05, 0.1], [-2.5, 2.0, 0.8]])
    starts = (truth + off).astype(np.float32)
    jbest, jval, _, jfinal = jmf.map_fit_batch(j_logd, jnp.asarray(starts), n_steps=40)
    tbest, tval, _, tfinal = tmf.map_fit_batch(t_logd, torch.as_tensor(starts), n_steps=40)
    gaps = np.diff(np.sort(np.asarray(jfinal)))
    assert gaps.min() > 10.0, jfinal          # the pick is not a float32 tie
    assert int(jnp.argmax(jfinal)) == int(torch.argmax(tfinal)) == 2
    np.testing.assert_allclose(tbest.numpy(), np.asarray(jbest), rtol=0, atol=MAP_X_ATOL)
    np.testing.assert_allclose(float(tval), float(jval), **LOGP_TOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), **LOGP_TOL)
