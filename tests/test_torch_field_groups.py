"""The port's field sampling stage held against the JAX package's on the same
inputs: the rectangular prior with kinds and liveness as data
(``_mixed_rect_logprior``), the group inputs the pipeline builds up to
sampling (fit groups, group cutout side, pixel sets, ownership masks,
neighbour effective skies, start states), the group log density's value
and gradient at the same states (a dead padding group included), and the
sampled catalog.

Both pipelines run tests/test_field.py's two-group frame (a blended star
pair and an isolated star, 64x64) at ``_small_cfg``'s width (12 chains),
cut in steps as tests/test_torch_field_sampling.py cuts them; the plain
kernel is slow on the CPU.  Each pipeline's group inputs are read from its
``run_field_pipeline`` frame when it summarizes its samples.  JAX computes
the group likelihood in plain jnp (``_loglik_jnp``); the port's goes
through K1's pixel-set mode, here its plain version.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu import field as jfield
from celeste_tpu.data.synthetic import make_synthetic_stamp as j_make_synthetic_stamp
from celeste_tpu.data.synthetic import galaxy_source as j_galaxy_source
from celeste_tpu.data.synthetic import star_source as j_star_source
from celeste_tpu.kernels import mog_field as jmf
from celeste_tpu.model.priors import FluxPrior as JFluxPrior
from celeste_tpu.model.priors import SourcePriors as JSourcePriors

from celeste_tpu_torch import field as tfield
from celeste_tpu_torch.bench.field_scale import CLUSTER_SEED, cluster_group, cluster_specs
from celeste_tpu_torch.kernels.mog_field import mixed_field_planes, pad_pixel_sets
from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

import torch_field_workers as w
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

J_PRIORS = JSourcePriors(flux=JFluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
# tests/test_field.py's _small_cfg (12 chains), cut in steps
SAMPLED = dict(w.SMALL, n_chains=12, probe_warmup=12, probe_steps=8, n_warmup=12, n_steps=24,
               max_leapfrog=24, map_steps=150)
LL_TOL = (2e-6, 0.5)        # K1-fwd's gate
GRAD_TOL = (5e-4, 5e-2)     # K1-bwd's gate


def _j_two_group_frame():
    """``torch_field_workers.two_group_frame`` made by the JAX package."""
    srcs = [
        j_star_source(u=(30.0 - 8 * w.ASU / w.COSD, 10.0 - 8 * w.ASU), flux_r=55.0),
        j_star_source(u=(30.0 + 7 * w.ASU / w.COSD, 10.0 + 7 * w.ASU), flux_r=45.0),
        j_star_source(u=(30.0 + (7 + 3.0) * w.ASU / w.COSD, 10.0 + 7 * w.ASU), flux_r=35.0),
    ]
    return j_make_synthetic_stamp(srcs, shape=(64, 64), bands=(2,), seed=23)


def _run_capturing(module, run):
    """``run()`` with ``module.summarize`` wrapped to keep the locals of the
    frame that first calls it (``run_field_pipeline``, after sampling)."""
    real, seen = module.summarize, {}

    def summarize(*a, **k):
        seen.setdefault("locals", dict(sys._getframe(1).f_locals))
        return real(*a, **k)

    module.summarize = summarize
    try:
        out = run()
    finally:
        module.summarize = real
    return out, seen["locals"]


@pytest.fixture(scope="module")
def runs():
    jstamp = _j_two_group_frame().stamps[0]
    tscene, _ = w.two_group_frame()
    jres, jloc = _run_capturing(jfield, lambda: jfield.run_field_pipeline(
        jstamp, band=0, n_bands=1, cfg=jfield.FieldConfig(**SAMPLED), priors=J_PRIORS))
    tres, tloc = _run_capturing(tfield, lambda: tfield.run_field_pipeline(
        tscene.stamps[0], band=0, n_bands=1, cfg=tfield.FieldConfig(**SAMPLED),
        priors=w.PRIORS))
    return tscene, (jres, jloc), (tres, tloc)


@pytest.mark.parametrize("n_bands", [1, 5])
def test_mixed_rect_logprior_matches_jax(n_bands):
    """The prior of [G, S, 6 + B] rectangular states, star and galaxy rows
    and dead rows mixed, galaxy shape slots beyond the clamp: value at rtol
    1e-6, gradient at rtol 1e-5, against JAX's on the same arrays."""
    rng = np.random.default_rng(11 + n_bands)
    g, s, gd = 4, 3, 6 + n_bands
    rect = rng.normal(size=(g, s, gd)).astype(np.float32)
    rect[..., 2:2 + n_bands] += 3.0                        # log fluxes near the prior
    rect[0, 1, 2 + n_bands:] = [20.0, -15.0, 3.0, 14.0]    # clamped galaxy slots
    flags = rng.random((g, s)) < 0.5
    alive = rng.random((g, s)) < 0.7
    alive[:, 0] = True
    alive[3] = False                                       # a dead (padding) group
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))

    def j_lp(r):
        return jfield._mixed_rect_logprior(r, jnp.asarray(flags), jnp.asarray(alive), J_PRIORS,
                                           n_bands)

    want = np.asarray(j_lp(jnp.asarray(rect)))
    want_g = np.asarray(jax.grad(lambda r: jnp.sum(j_lp(r)))(jnp.asarray(rect)))
    x = torch.tensor(rect, requires_grad=True)
    got = tfield._mixed_rect_logprior(x, torch.as_tensor(flags), torch.as_tensor(alive), priors,
                                      n_bands)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    assert got.shape == (g,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=1e-5)
    # a dead group is the standard-normal anchor on every slot
    np.testing.assert_allclose(got[3].item(), -0.5 * np.sum(rect[3].astype(np.float64) ** 2),
                               rtol=1e-6)


def test_group_inputs_match_jax(runs):
    """Up to sampling the two pipelines build the same fit groups, group
    cutout side, pixel sets, counts and ownership masks, bitwise; the same
    effective skies (neighbour groups' MAP lambdas folded in) and start
    rectangles within float32 MAP noise; the same kinds and liveness."""
    _, (_, j), (_, t) = runs
    assert t["gcut"] == j["gcut"] and t["s_max"] == j["s_max"] == 2
    assert t["members"] == j["members"] and t["n_groups"] == j["n_groups"] == 2
    np.testing.assert_array_equal(t["labels"], j["labels"])
    for k in ("g_px", "g_py", "g_cts", "g_mk", "flg_g", "alv_g"):
        np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)
    # the ownership masks split the group cutouts' pixels: no pixel counts twice
    owned = [{(x, y) for x, y, m in zip(t["g_px"][g, 0], t["g_py"][g, 0], t["g_mk"][g, 0]) if m}
             for g in range(2)]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    np.testing.assert_allclose(t["g_eff"], np.asarray(j["g_eff"]), rtol=1e-5)
    assert bool((t["g_eff"] >= t["g_sky"]).all())
    np.testing.assert_allclose(t["rect_g"], np.asarray(j["rect_g"]), rtol=1e-5, atol=1e-4)


def test_group_logdensity_matches_jax(runs):
    """The port's group log density on JAX's group inputs equals JAX's
    ``group_logd`` at JAX's start states, value and gradient at K1's gates,
    with a dead padding group appended as each package pads (mask 0, alive
    0, effective sky 1, counts 0), whose value is the anchor prior alone."""
    tscene, (_, j), _ = runs
    n_g, nb = int(j["n_groups"]), SAMPLED["n_chains"]
    x0b = np.asarray(j["x0b"])                                  # [G, B, D]
    d = x0b.shape[-1]
    dead_x = np.random.default_rng(5).normal(size=(1, nb, d)).astype(np.float32)
    x = np.concatenate([x0b, dead_x])
    flg = np.concatenate([np.asarray(j["flg_g"]), np.zeros((1, 2), bool)])
    alv = np.concatenate([np.asarray(j["alv_g"]), np.zeros((1, 2), bool)])
    px, py = (np.concatenate([np.asarray(j[k]), np.asarray(j[k])[:1]]) for k in ("g_px", "g_py"))
    cts, eff, mk = (np.concatenate([np.asarray(j[k]), np.full((1,) + j[k].shape[1:], v,
                                                               np.float32)])
                    for k, v in (("g_cts", 0.0), ("g_eff", 1.0), ("g_mk", 0.0)))

    per_chain = jax.value_and_grad(j["group_logd"])
    j_fn = jax.jit(jax.vmap(jax.vmap(per_chain, in_axes=(0,) + (None,) * 7)))
    want, want_g = (np.asarray(a) for a in j_fn(*(jnp.asarray(a) for a in (
        x, flg, alv, px, py, cts, eff, mk))))

    fr = tfield._Frames([tscene.stamps[0]], [0], 1, w.PRIORS)
    sets = [pad_pixel_sets(*(torch.as_tensor(a[:, 0]) for a in (px, py, cts, eff, mk)))]
    logd = tfield._group_logdensity(fr, sets, torch.as_tensor(flg), torch.as_tensor(alv))
    xt = torch.tensor(x.reshape(-1, d), requires_grad=True)
    got = logd(xt)
    (got_g,) = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), want.reshape(-1), rtol=LL_TOL[0],
                               atol=LL_TOL[1])
    np.testing.assert_allclose(got_g.numpy(), want_g.reshape(-1, d), rtol=GRAD_TOL[0],
                               atol=GRAD_TOL[1])
    anchor = -0.5 * np.sum(dead_x[0].astype(np.float64) ** 2, -1)
    np.testing.assert_allclose(got.detach().numpy()[n_g * nb:], anchor, rtol=1e-6)


def test_sampled_catalog_matches_jax(runs):
    """The port's sampled catalog against JAX's sampled run on the same
    frame and settings: the same sources, kinds and groups; posterior means
    of position and flux within 4 combined Monte Carlo standard errors
    (posterior sd / sqrt(ESS), ESS the group's smallest), flux sds within
    35%, and both runs' groups mixed."""
    _, ((jcat, jart), _), ((tcat, tart), _) = runs
    assert len(tcat) == len(jcat) == 3 and tart["n_groups"] == jart["n_groups"] == 2
    ess = {"port": [d["ess_min"] for d in tart["diagnostics"]],
           "jax": [d["ess_min"] for d in jart["diagnostics"]]}
    for et, ej in zip(tcat, jcat):
        assert et.kind == ej.kind and et.extras["group"] == ej.extras["group"]
        n_t, n_j = ess["port"][et.extras["group"]], ess["jax"][ej.extras["group"]]
        for mean, sd in (("du_mean", "du_std"), ("flux_mean", "flux_std")):
            mt, mj = np.asarray(getattr(et, mean)), np.asarray(getattr(ej, mean))
            st, sj = np.asarray(getattr(et, sd)), np.asarray(getattr(ej, sd))
            se = np.sqrt(st ** 2 / n_t + sj ** 2 / n_j)
            assert bool((np.abs(mt - mj) < 4.0 * se).all()), (mean, mt, mj, se)
        ratio = float(et.flux_std[0]) / float(ej.flux_std[0])
        assert 0.65 < ratio < 1.55, ratio
    for d in tart["diagnostics"] + jart["diagnostics"]:
        assert d["rhat_max"] < 1.1 and d["divergence_rate"] < 0.05, d


def test_crowded_group_of_20_sources_matches_jax():
    """A galaxy cluster (10 stars, 10 galaxies 2'' apart) links into one fit
    group of 20 sources, 960 components a row, past the old whole-row
    staging of K1 and K7 on the card: ``union_groups`` gives JAX's labels at
    the default link radius, and the port's group log density
    (``field._group_logdensity``) equals JAX's ``group_logd``
    (``celeste_tpu/field.py:903-916``, rebuilt here on its own pieces for the
    one frame) at 4 chains around the truth, value and gradient at K1's
    gates, as ``test_group_logdensity_matches_jax``."""
    tscene, pos, rects, is_star, pixels = cluster_group()
    link = tfield.FieldConfig().link_radius_px
    labels = tfield.union_groups(pos, link)
    np.testing.assert_array_equal(labels, jfield.union_groups(pos, link))
    assert set(labels.tolist()) == {0}

    jsrcs = [j_star_source(**kw) if kind == "star" else j_galaxy_source(**kw)
             for kind, kw in cluster_specs()]
    jstamp = j_make_synthetic_stamp(jsrcs, shape=(64, 64), bands=(2,),
                                    seed=CLUSTER_SEED).stamps[0]
    s_max, gd = rects.shape
    flg, alv = is_star, np.ones(s_max, bool)
    x = (rects.reshape(1, -1)
         + 0.01 * np.random.default_rng(3).normal(size=(4, s_max * gd))).astype(np.float32)

    def group_logd(xv, fl, al, pxg, pyg, ctsg, effg, mkg):
        rect = xv.reshape(s_max, gd)
        planes = jax.vmap(lambda v, f: jmf.mixed_field_planes(v, jstamp, 0, 1, f))(rect, fl)
        amp = planes[0] * al[:, None]
        flat = tuple(p.reshape(1, -1) for p in (amp,) + planes[1:])
        ll = jmf._loglik_jnp(*flat, pxg[None], pyg[None], ctsg[None], effg[None], mkg[None],
                             centered=True)[0]
        return ll + jfield._mixed_rect_logprior(rect, fl, al, J_PRIORS, 1)

    j_fn = jax.jit(jax.vmap(jax.value_and_grad(group_logd), in_axes=(0,) + (None,) * 7))
    want, want_g = (np.asarray(a) for a in j_fn(*(jnp.asarray(a) for a in (x, flg, alv,
                                                                           *pixels))))

    fr = tfield._Frames([tscene.stamps[0]], [0], 1, w.PRIORS)
    sets = [pad_pixel_sets(*(torch.as_tensor(a[None]) for a in pixels))]
    rows = mixed_field_planes(torch.as_tensor(rects), tscene.stamps[0], 0, 1,
                              torch.as_tensor(is_star))[0]
    assert rows.shape[0] * rows.shape[1] == 960
    logd = tfield._group_logdensity(fr, sets, torch.as_tensor(flg[None]),
                                    torch.as_tensor(alv[None]))
    xt = torch.tensor(x, requires_grad=True)
    got = logd(xt)
    (got_g,) = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LL_TOL[0], atol=LL_TOL[1])
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=GRAD_TOL[0], atol=GRAD_TOL[1])
