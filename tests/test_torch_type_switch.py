"""Carlin-Chib type switching of the port (``celeste_tpu_torch/inference/
type_switch.py``) against the JAX package and against exact answers.

Tolerances: the pseudo-prior's mean within atol 2e-3 of JAX's (both Adam
MAPs of one float32 posterior); its Cholesky factor within rtol 1e-2 (the
port's Hessian is central differences of the gradient, JAX's
``jax.hessian``: 1/2 log det agrees within 0.01 nats,
tests/test_torch_model_select.py) and log det(cov) within 0.02; the
log density of a carried JAX pseudo-prior within rtol 1e-5 of JAX's.  On
two exact Gaussians the pseudo-priors are exact, so every step's
conditional P(star) is the analytic posterior odds: within 1e-3.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu.inference import type_switch as jts
from celeste_tpu.inference.problems import make_galaxy_logdensity as j_gal_logd
from celeste_tpu.inference.problems import make_star_logdensity as j_star_logd

from celeste_tpu_torch.inference import type_switch as tts
from celeste_tpu_torch.inference.problems import make_galaxy_logdensity as t_gal_logd
from celeste_tpu_torch.inference.problems import make_star_logdensity as t_star_logd
from celeste_tpu_torch.interop import pseudo_prior_from_numpy, type_switch_state_from_numpy
from celeste_tpu_torch.utils.rng import seeded_generator

from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

MEAN_ATOL = 2e-3
CHOL_TOL = dict(rtol=1e-2, atol=1e-5)
LOGDET_ATOL = 0.02


@pytest.fixture(scope="module")
def source_problems():
    """tests/test_type_switch.py's vmappable-run star (19x19) and a galaxy
    on the same stamp size: each model's posterior in both packages, and
    starts as detection gives them."""
    out = {}
    for kind in ("star", "galaxy"):
        if kind == "star":
            src = star_source(u=(30.0001, 10.0), flux_r=30.0)
        else:
            src = galaxy_source(u=(30.0001, 10.0), flux_r=60.0, sigma=1.2, ab=0.7)
        scene = make_synthetic_stamp([src], shape=(19, 19), bands=(2,), seed=4)
        du = scene.wcs.equa2duas(src["u"])
        x0 = np.concatenate([du, [np.log(src["flux"][2])]]).astype(np.float32)
        if kind == "galaxy":
            x0 = np.concatenate([x0, [0.0, 0.0, np.log(0.7 / 0.3), 0.0]]).astype(np.float32)
        make_j, make_t = (j_star_logd, t_star_logd) if kind == "star" else (j_gal_logd,
                                                                           t_gal_logd)
        out[kind] = (make_j(scene.stamps, [0], n_bands=1),
                     make_t([port_stamp(s) for s in scene.stamps], [0], n_bands=1), x0)
    return out


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_fit_pseudo_prior_matches_jax(source_problems, kind):
    j_logd, t_logd, x0 = source_problems[kind]
    jp, jz = jax.jit(lambda x: jts.fit_pseudo_prior(j_logd, x, n_map_steps=300))(
        jnp.asarray(x0))
    tp, tz = tts.fit_pseudo_prior(t_logd, torch.as_tensor(x0)[None], n_map_steps=300)
    np.testing.assert_allclose(tp.mean[0].numpy(), np.asarray(jp.mean), rtol=0, atol=MEAN_ATOL)
    np.testing.assert_allclose(tp.chol[0].numpy(), np.asarray(jp.chol), **CHOL_TOL)
    assert abs(float(tp.logdet_cov[0]) - float(jp.logdet_cov)) < LOGDET_ATOL
    np.testing.assert_allclose(float(tz[0]), float(jz), rtol=2e-6, atol=1.0)

    # JAX's pseudo-prior carried across scores points as JAX's does
    carried = pseudo_prior_from_numpy(np.asarray(jp.mean), np.asarray(jp.chol),
                                      np.asarray(jp.logdet_cov))
    rng = np.random.default_rng(3)
    pts = (np.asarray(jp.mean) + 0.01 * rng.normal(size=(5, x0.size))).astype(np.float32)
    want = np.asarray(jax.vmap(jp.logpdf)(jnp.asarray(pts)))
    got = carried.rows(5).logpdf(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _gaussian_pair(log_z, means, scales):
    """Star (D = 2) and galaxy (D = 3) log densities of N candidates, each
    an unnormalised Gaussian with the given log normaliser: row r of a
    batch belongs to candidate r // (R / N)."""
    log_z = torch.as_tensor(log_z, dtype=torch.float32)
    means = [torch.as_tensor(m, dtype=torch.float32) for m in means]
    scales = [torch.as_tensor(s, dtype=torch.float32) for s in scales]

    def make(block, d):
        def logd(x):
            k = x.shape[0] // log_z.shape[0]
            m, s = means[block].repeat_interleave(k, 0), scales[block].repeat_interleave(k, 0)
            z = (x - m) / s
            lz = log_z[:, block].repeat_interleave(k, 0)
            return (lz - 0.5 * torch.sum(z * z, -1) - torch.sum(torch.log(s), -1)
                    - 0.5 * d * math.log(2 * math.pi))
        return logd

    return make(0, 2), make(1, 3)


def test_p_star_on_a_gaussian_pair_is_the_analytic_odds():
    """Exact Gaussian models with evidences Z_s, Z_g: P(star) = Z_s / (Z_s +
    Z_g) at prior 1/2, the counterpart of tests/test_type_switch.py's
    agreement with the Laplace classifier, where Laplace is exact."""
    log_z = np.array([[0.3, -0.4], [-1.0, 1.5]])
    means = (np.array([[0.5, -1.0], [2.0, 0.0]]), np.array([[1.0, 0.0, -2.0], [0.0, 1.0, 0.5]]))
    scales = (np.array([[0.5, 2.0], [1.0, 0.3]]), np.array([[1.0, 0.7, 3.0], [0.2, 0.4, 1.5]]))
    ls, lg = _gaussian_pair(log_z, means, scales)
    gens = [seeded_generator("cpu", 11, i) for i in range(2)]
    out = tts.sample_source_type_core(gens, ls, lg, torch.zeros(2, 2), torch.zeros(2, 3),
                                      n_chains=4, n_steps=120, n_map_steps=300)
    want = 1.0 / (1.0 + np.exp(log_z[:, 1] - log_z[:, 0]))
    np.testing.assert_allclose(out["p_star"].numpy(), want, rtol=0, atol=1e-3)
    # the 0/1 indicator mean agrees within its Monte Carlo error
    assert np.all(np.abs(out["p_star_indicator"].numpy() - want) < 0.2)
    assert out["a_trace"].shape == (2, 4, 120)
    assert np.all((out["switch_rate"].numpy() > 0.05) & (out["switch_rate"].numpy() < 0.95))
    for key, m in (("x_star_mean", means[0]), ("x_gal_mean", means[1])):
        np.testing.assert_allclose(out[key].numpy(), m, rtol=0, atol=0.5)


def _banana_pair(shift):
    """Non-Gaussian star and galaxy models of N candidates (candidate i's
    shifted by shift[i]), so the pseudo-priors are approximate and P(star)
    depends on the draws."""
    shift = torch.as_tensor(shift, dtype=torch.float32)

    def make(d, lz):
        def logd(x):
            k = x.shape[0] // shift.shape[0]
            y = x - shift.repeat_interleave(k)[:, None]
            return lz - 0.5 * torch.sum(y * y, -1) - 0.3 * (y[:, 0] - 0.5 * y[:, 1] ** 2) ** 2
        return logd

    return make(2, 0.2), make(3, 0.0)


def test_p_star_of_a_candidate_does_not_depend_on_its_batch():
    """Candidate 0 alone and beside candidate 1, each drawing from its own
    stream (seed, i): its P(star), switch rate and conditional means are
    equal.  These log densities are plain torch, whose rows do not depend
    on the batch's size; through K1 on the card they do (its pixel split
    follows the row count), and there the runs agree in distribution only."""
    shifts = [0.4, -1.3]
    runs = []
    for n in (1, 2):
        ls, lg = _banana_pair(shifts[:n])
        gens = [seeded_generator("cpu", 5, i) for i in range(n)]
        runs.append(tts.sample_source_type_core(gens, ls, lg, torch.zeros(n, 2),
                                                torch.zeros(n, 3), n_chains=4, n_steps=60,
                                                n_map_steps=100))
    alone, pair = runs
    for key in ("p_star", "switch_rate", "x_star_mean", "x_gal_mean"):
        np.testing.assert_allclose(pair[key][0].numpy(), alone[key][0].numpy(), rtol=0,
                                   atol=1e-6)
    assert torch.equal(pair["a_trace"][0], alone["a_trace"][0])
    assert 0.0 < float(pair["p_star"][0]) < 1.0


def test_kernel_runs_from_a_jax_state_and_jax_pseudo_priors():
    """A JAX type-switch state and JAX's fitted pseudo-priors, carried by
    ``interop``, drive the port's kernel: the carried log densities are the
    port's at the carried points, and a step keeps shapes and finite
    values."""
    log_z = np.array([[0.2, 0.0]])
    means = (np.array([[0.5, -1.0]]), np.array([[1.0, 0.0, -2.0]]))
    scales = (np.array([[0.5, 2.0]]), np.array([[1.0, 0.7, 3.0]]))
    ls, lg = _gaussian_pair(log_z, means, scales)

    def j_logd(block):
        m, s = jnp.asarray(means[block][0], jnp.float32), jnp.asarray(scales[block][0], jnp.float32)
        d = m.shape[0]
        return lambda x: (log_z[0, block] - 0.5 * jnp.sum(((x - m) / s) ** 2)
                          - jnp.sum(jnp.log(s)) - 0.5 * d * jnp.log(2 * jnp.pi))

    jps, _ = jts.fit_pseudo_prior(j_logd(0), jnp.zeros(2), n_map_steps=200)
    jpg, _ = jts.fit_pseudo_prior(j_logd(1), jnp.zeros(3), n_map_steps=200)
    keys = jax.random.split(jax.random.key(0), 3)
    jstate = jax.vmap(lambda k: jts.type_switch_init(jps.sample(k), jpg.sample(k), j_logd(0),
                                                     j_logd(1), a0=1))(keys)
    state = type_switch_state_from_numpy(
        np.asarray(jstate.a), np.asarray(jstate.star.x), np.asarray(jstate.star.logp),
        np.asarray(jstate.star.grad), np.asarray(jstate.gal.x), np.asarray(jstate.gal.logp),
        np.asarray(jstate.gal.grad))
    np.testing.assert_allclose(ls(state.star.x).numpy(), state.star.logp.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lg(state.gal.x).numpy(), state.gal.logp.numpy(), rtol=1e-5,
                               atol=1e-5)
    ps = pseudo_prior_from_numpy(np.asarray(jps.mean), np.asarray(jps.chol),
                                 np.asarray(jps.logdet_cov)).rows(3)
    pg = pseudo_prior_from_numpy(np.asarray(jpg.mean), np.asarray(jpg.chol),
                                 np.asarray(jpg.logdet_cov)).rows(3)
    kern = tts.type_switch_kernel(ls, lg, ps, pg, 0.5, 0.5)
    new, info = kern(seeded_generator("cpu", 0), state)
    assert new.a.shape == (3,) and new.star.x.shape == (3, 2) and new.gal.x.shape == (3, 3)
    assert torch.isfinite(info.p_star_cond).all()
    # exact pseudo-priors: the conditional odds are the evidences'
    np.testing.assert_allclose(info.p_star_cond.numpy(), 1 / (1 + np.exp(-0.2)), atol=1e-3)
