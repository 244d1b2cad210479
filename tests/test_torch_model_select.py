"""Laplace model selection of the port (``celeste_tpu_torch/inference/
model_select.py``) against the JAX package's.

The port's Hessian is central differences of the batched gradient (the
card's log density runs through K1, whose backward has no derivative); the
JAX package takes ``jax.hessian``.  Tolerances: 1/2 log det(-H) within 0.01
nats (the pipeline decides on margins of 5 and 10 nats); the evidence within
rtol 2e-6, atol 1.0 (log densities of ~1.2e6 nats, whose float32 ulp is
0.125); a Gaussian's evidence exact within 1e-4, as tests/test_model_select.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu.inference.map_fit import map_fit as j_map_fit
from celeste_tpu.inference.model_select import classify_source as j_classify
from celeste_tpu.inference.model_select import laplace_evidence as j_laplace
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors

from celeste_tpu_torch.inference.model_select import (
    FD_STEP,
    classify_source,
    hessian_fd,
    laplace_evidence,
)
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors
from celeste_tpu_torch.pipeline import Conditional

from torch_pipeline_jax import jax_pipeline_machinery
from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

HALF_LOGDET_ATOL = 0.01
EVIDENCE_TOL = dict(rtol=2e-6, atol=1.0)
PIPE_PRIORS = (JPriors(flux=JFlux(log_ref_mean=3.2, log_ref_std=2.0)),
               TPriors(flux=TFlux(log_ref_mean=3.2, log_ref_std=2.0)))


def test_laplace_evidence_gaussian_exact():
    """An exact Gaussian's Laplace evidence is its normaliser."""
    s = 0.7
    lz = laplace_evidence(lambda x: -0.5 * torch.sum(x * x, -1) / s ** 2, torch.zeros(3, 2))
    want = 2 * math.log(math.sqrt(2 * math.pi) * s)
    assert lz.shape == (3,)
    np.testing.assert_allclose(lz.numpy(), want, rtol=0, atol=1e-4)


def test_hessian_fd_of_a_quadratic_is_exact():
    """Central differences are exact on a quadratic: rows of a batch with
    their own precisions come back with them, symmetric."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 3, 3))
    prec = torch.as_tensor(np.einsum("nij,nkj->nik", a, a) + 3 * np.eye(3), dtype=torch.float32)
    x0 = torch.as_tensor(rng.normal(size=(4, 3)), dtype=torch.float32)

    def logd(x):
        n = x.shape[0] // 4
        p = prec.repeat_interleave(n, 0)
        return -0.5 * torch.einsum("bi,bij,bj->b", x, p, x)

    logp, h = hessian_fd(logd, x0)
    np.testing.assert_allclose(h.numpy(), -prec.numpy(), rtol=1e-3, atol=1e-3)
    assert torch.equal(h, h.transpose(1, 2))
    np.testing.assert_allclose(logp.numpy(), logd(x0).numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def pipeline_conditionals():
    """The ``pipeline`` config's field with its three sources at the truth
    as the candidates; the JAX MAPs of candidate 0's star model and
    candidate 2's galaxy model on their conditional posteriors, with JAX's
    Hessians (``jax.hessian``) and evidences there, and the port's folded
    conditional log densities of the same problems."""
    cosd = np.cos(np.deg2rad(10.0))
    srcs = [
        star_source(u=(30.0 - 3.5 / 3600 / cosd, 10.0 - 2.0 / 3600), flux_r=35.0),
        star_source(u=(30.0 + 3.0 / 3600 / cosd, 10.0 + 2.5 / 3600), flux_r=25.0),
        galaxy_source(u=(30.0, 10.0), flux_r=70.0, sigma=1.8, ab=0.6),
    ]
    scene = make_synthetic_stamp(srcs, shape=(33, 33), bands=(2,), seed=101)
    rects = np.zeros((3, 7), np.float32)
    for i, s in enumerate(srcs):
        rects[i, :2] = scene.wcs.equa2duas(s["u"])
        rects[i, 2] = np.log(s["flux"][2])
        rects[i, 3:] = [0.0, 0.0, 0.0, 0.5]
    g = srcs[2]
    rects[2, 3:] = [np.log(g["theta_dev"] / (1 - g["theta_dev"])), np.log(g["sigma"]),
                    np.log(g["ab"] / (1 - g["ab"])), g["phi"]]
    flags, alive = np.array([True, True, False]), np.ones(3, bool)
    jm = jax_pipeline_machinery(scene.stamps, [0], 1, PIPE_PRIORS[0], map_steps=250)
    effs = jm.scene_effs(jnp.asarray(rects), jnp.asarray(flags), jnp.asarray(alive))
    out = {}
    for kind, i, x0 in (("star", 0, rects[0, :3]), ("galaxy", 2, rects[2])):
        eff_i = [e[i] for e in effs]
        logd = jax.jit(lambda x, e=eff_i, k=kind: jm.cond_logd(k)(x, e))
        x_map, _ = jax.jit(lambda x, f=logd: j_map_fit(f, x, n_steps=250))(jnp.asarray(x0))
        h = np.asarray(jax.jit(jax.hessian(logd))(x_map), np.float64)
        half_logdet = 0.5 * np.linalg.slogdet(-(h + h.T) / 2)[1]
        out[kind] = dict(cand=i, x_map=np.asarray(x_map), half_logdet=half_logdet,
                         evidence=float(j_laplace(logd, x_map)), logp=float(logd(x_map)))
    cond = Conditional([port_stamp(s) for s in scene.stamps], [0], 1, PIPE_PRIORS[1])
    folded = cond.fold(rects, flags, alive)
    for kind in out:
        out[kind]["port_logd"] = cond.logdensity(kind, [out[kind]["cand"]], folded)
    return out


@pytest.mark.parametrize("step", [1e-3, FD_STEP, 1e-2])
@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_half_logdet_matches_jax_hessian(pipeline_conditionals, kind, step):
    """1/2 log det(-H) from the port's difference Hessian at JAX's MAP, on
    the folded conditional, against ``jax.hessian`` of JAX's effective-sky
    conditional (D = 3 and 7), at the step the port takes and a decade
    around it."""
    c = pipeline_conditionals[kind]
    logp, h = hessian_fd(c["port_logd"], torch.as_tensor(np.array(c["x_map"]))[None], step)
    half_logdet = 0.5 * float(torch.linalg.slogdet(-h[0].double())[1])
    assert abs(half_logdet - c["half_logdet"]) < HALF_LOGDET_ATOL, (half_logdet,
                                                                   c["half_logdet"])
    np.testing.assert_allclose(float(logp[0]), c["logp"], **EVIDENCE_TOL)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_evidence_matches_jax(pipeline_conditionals, kind):
    c = pipeline_conditionals[kind]
    lz = laplace_evidence(c["port_logd"], torch.as_tensor(np.array(c["x_map"]))[None])
    np.testing.assert_allclose(float(lz[0]), c["evidence"], **EVIDENCE_TOL)


def _inits(scene, src):
    du = scene.wcs.equa2duas(src["u"])
    lf = [np.log(src["flux"][2])]
    x0_star = np.concatenate([du, lf]).astype(np.float32)
    x0_gal = np.concatenate([du, lf, [0.0, np.log(1.0), 0.0, 0.5]]).astype(np.float32)
    return x0_star, x0_gal


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_classify_source_on_the_same_side_as_jax(kind):
    """tests/test_model_select.py's clear star and clear galaxy: P(star)
    past 0.9 / below 0.1 in both packages, and the two log evidences of
    each model within the evidence gate."""
    if kind == "star":
        src = star_source(u=(30.0, 10.0), flux_r=40.0)
        scene = make_synthetic_stamp([src], shape=(23, 23), bands=(2,), seed=41)
    else:
        src = galaxy_source(u=(30.0, 10.0), flux_r=80.0, sigma=2.0, ab=0.5)
        scene = make_synthetic_stamp([src], shape=(27, 27), bands=(2,), seed=42)
    xs, xg = _inits(scene, src)
    priors = (JPriors(flux=JFlux(log_ref_mean=3.4, log_ref_std=2.0)),
              TPriors(flux=TFlux(log_ref_mean=3.4, log_ref_std=2.0)))
    j = jax.jit(lambda a, b: j_classify(scene.stamps, bands=[0], x0_star=a, x0_galaxy=b,
                                        priors=priors[0], n_bands=1))(jnp.asarray(xs),
                                                                     jnp.asarray(xg))
    t = classify_source([port_stamp(s) for s in scene.stamps], bands=[0],
                        x0_star=torch.as_tensor(xs), x0_galaxy=torch.as_tensor(xg),
                        priors=priors[1], n_bands=1)
    jp, tp = float(j["p_star"]), float(t["p_star"])
    if kind == "star":
        assert jp > 0.9 and tp > 0.9, (jp, tp)
    else:
        assert jp < 0.1 and tp < 0.1, (jp, tp)
    for key in ("log_evidence_star", "log_evidence_galaxy"):
        np.testing.assert_allclose(float(t[key]), float(j[key]), **EVIDENCE_TOL)
