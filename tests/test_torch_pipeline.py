"""The stamp catalog pipeline of the port (``celeste_tpu_torch/pipeline.py``,
``catalog.py``, ``ppc.catalog_vs_truth``, the ``pipeline`` config) against
the JAX package's, on tests/test_pipeline.py's ``mixed_field`` (two stars
and a galaxy on a 33x33 stamp) at that file's detection and classification
settings.

The port's run is cut in sampling steps and JAX's stops before its
sampling (no decision depends on it; tests/test_torch_pipeline_catalog.py
samples on from the port's run's candidates and holds the catalog).  JAX's stage closures are rebuilt in
``torch_pipeline_jax.py`` and evaluated at the inputs the port's stages
saw.  Tolerances: CLEAN star MAPs within atol 2e-3; each sweep's
evidences (lz_s, lz_g, lz_0, ~1.2e6 nats) within rtol 2e-6, atol 1.0 (the
stamp kernel gate, and the float32 ulp of 0.125 there); the sweep MAPs
within atol 0.02 (250 Adam steps from one start on two float32 sums of the
posterior); the folded conditional against JAX's effective-sky one within
rtol 2e-6, atol 1.0, its gradient within rtol 5e-4, atol 0.1.  The
catalogue scoring is NumPy in both packages: equal.
"""

import copy
import functools
import io
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu import catalog as jcat
from celeste_tpu import pipeline as jpipe
from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors
from celeste_tpu.ppc import catalog_vs_truth as j_catalog_vs_truth
from celeste_tpu.utils.metrics import MetricsLogger as JLogger

from celeste_tpu_torch import catalog as tcat
from celeste_tpu_torch import pipeline as tpipe
from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene, run_experiment
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors
from celeste_tpu_torch.ppc import catalog_vs_truth

from torch_pipeline_jax import jax_pipeline_machinery, rects_of
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse fixture)
    PIPELINE_DECISION_CFG,
    one_torch_thread,
    pipeline_decision_run,
    port_stamp,
)

J_PRIORS = JPriors(flux=JFlux(log_ref_mean=3.2, log_ref_std=2.0))
T_PRIORS = TPriors(flux=TFlux(log_ref_mean=3.2, log_ref_std=2.0))
MAP_ATOL = 2e-3
SWEEP_MAP_ATOL = 0.02
EVIDENCE_TOL = dict(rtol=2e-6, atol=1.0)


def _events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def mixed_field():
    """tests/test_pipeline.py's field: the ``pipeline`` config's scene."""
    tscene, srcs = pipeline_scene(CONFIGS["pipeline"], "cpu")
    jscene = make_synthetic_stamp(srcs, shape=(33, 33), bands=(2,), seed=101)
    return jscene, tscene, srcs


@pytest.fixture(scope="module")
def port_run():
    """The port's run at the decision settings, with what its stages saw
    (``torch_port_helpers.pipeline_decision_run``, shared with
    tests/test_torch_pipeline_catalog.py)."""
    return pipeline_decision_run()


class _Decided(Exception):
    """Raised where JAX's run would start its joint sampling."""


@pytest.fixture(scope="module")
def jax_run(mixed_field):
    """JAX's run at the same settings, with its type switch on (so that it
    reports the ambiguous set), stopped where its joint sampling would
    start (no decision depends on it), and its stage machinery."""
    jscene, _, _ = mixed_field
    buf = io.StringIO()
    cfg = jpipe.PipelineConfig(type_switch=True, type_switch_steps=20,
                               **PIPELINE_DECISION_CFG)

    def decided(*args, **kw):
        raise _Decided

    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Decided):
        mp.setattr(jpipe, "make_crowded_logdensity", decided)
        jpipe.run_pipeline(jscene.stamps[0], band=0, n_bands=1, cfg=cfg, priors=J_PRIORS,
                           logger=JLogger(stream=buf))
    machinery = jax_pipeline_machinery(jscene.stamps, [0], 1, J_PRIORS, map_steps=250)
    return {"events": _events(buf), "m": machinery}


def test_detections_and_clean_maps_match_jax(port_run, jax_run):
    """The same peaks in the same order (the SNRs JAX logs, to 0.1), and
    every CLEAN star MAP within atol 2e-3 of JAX's detection fit from the
    same start on the same residual."""
    t_det = [e for e in port_run["events"] if e["event"] == "detect"][0]
    j_det = [e for e in jax_run["events"] if e["event"] == "detect"][0]
    assert t_det["n_candidates"] == j_det["n_candidates"] == 5
    assert t_det["snrs"] == j_det["snrs"]
    pad = jax_run["m"].pds[0][0].shape[1]
    for x0, work, x_map in port_run["rec"]["det"]:
        counts = jnp.asarray(np.pad(work[0].ravel(), (0, pad - work[0].size)), jnp.float32)
        jx, _ = jax_run["m"].det_fit(jnp.asarray(x0), (counts,))
        np.testing.assert_allclose(x_map, np.asarray(jx), rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("sweep", [0, 1, 2])
def test_sweep_evidences_match_jax(port_run, jax_run, sweep):
    """JAX's batched sweep at the port's sweep inputs: every alive
    candidate's lz_s, lz_g and lz_0, and its star and galaxy MAPs."""
    rec = port_run["rec"]["sweeps"][sweep]
    before = rec["before"]
    rects = rects_of(before, 1)
    flags = np.array([c["kind"] == "star" for c in before])
    alive = np.array([c["alive"] for c in before])
    jxs, jlzs, jxg, jlzg, jlz0 = (np.asarray(a) for a in jax_run["m"].classify_sweep_batch(
        jnp.asarray(rects), jnp.asarray(flags), jnp.asarray(alive)))
    assert sorted(rec["results"]) == list(np.flatnonzero(alive))
    for i, (xs, lz_s, xg, lz_g, lz_0) in rec["results"].items():
        np.testing.assert_allclose([lz_s, lz_g, lz_0], [jlzs[i], jlzg[i], jlz0[i]],
                                   **EVIDENCE_TOL)
        np.testing.assert_allclose(xs, jxs[i], rtol=0, atol=SWEEP_MAP_ATOL)
        np.testing.assert_allclose(xg, jxg[i], rtol=0, atol=SWEEP_MAP_ATOL)


def test_decisions_match_jax(port_run, jax_run):
    """Per sweep the same kinds, the same pruned count and P(star) within
    the evidence gate (logits within 2 nats); then the same ambiguous
    set, the candidates JAX's type switch took."""
    t_sw = [e for e in port_run["events"] if e["event"] == "classify_sweep"]
    j_sw = [e for e in jax_run["events"] if e["event"] == "classify_sweep"]
    assert len(t_sw) == len(j_sw) == 3
    for t, j in zip(t_sw, j_sw):
        assert t["kinds"] == j["kinds"] and t["pruned"] == j["pruned"], (t, j)
        for pt, pj in zip(t["p_star"], j["p_star"]):
            if abs(pt - pj) > 2e-3:
                lt, lj = (math.log(p / (1 - p)) for p in (pt, pj))
                assert abs(lt - lj) < 2.0, (t["p_star"], j["p_star"])
    last = port_run["rec"]["sweeps"][-1]
    amb = tpipe.ambiguous_candidates(last["after"], last["results"], port_run["cfg"])
    j_ts = [e for e in jax_run["events"] if e["event"] == "type_switch"]
    assert len(j_ts) == 1 and amb == j_ts[0]["candidates"], (amb, j_ts)
    assert [c["kind"] for c in last["after"] if c["alive"]] == ["star", "galaxy", "star"]


@pytest.fixture(scope="module")
def folded_scene(mixed_field, jax_run):
    """The field's three sources as candidates (the galaxy's shape off its
    truth) and a fourth, dead one; JAX's effective skies of each and the
    port's folded scene."""
    jscene, tscene, srcs = mixed_field
    cand = []
    for s in srcs + [star_source(u=(30.0005, 10.0004), flux_r=10.0)]:
        x = np.concatenate([tscene.wcs.equa2duas(s["u"]), [np.log(s["flux"][2])]])
        if s["type"] == "galaxy":
            x = np.concatenate([x, [-0.4, np.log(s["sigma"]), 0.4, s["phi"]]])
        cand.append({"kind": s["type"], "x": x.astype(np.float32), "alive": len(cand) != 3})
    rects = rects_of(cand, 1)
    flags = np.array([c["kind"] == "star" for c in cand])
    alive = np.array([c["alive"] for c in cand])
    effs = jax_run["m"].scene_effs(jnp.asarray(rects), jnp.asarray(flags), jnp.asarray(alive))
    cond = tpipe.Conditional([port_stamp(jscene.stamps[0])], [0], 1, T_PRIORS)
    return rects, np.asarray(effs[0]), cond, cond.fold(rects, flags, alive)


@pytest.mark.parametrize("kind", ["star", "galaxy", "mixed"])
def test_folded_conditional_equals_jax_effective_sky(folded_scene, jax_run, kind):
    """The port's conditional (the others folded in as fixed components)
    against JAX's ``_cond_logd`` (the others in an effective sky), for each
    alive candidate of a scene with one dead candidate, at 4 points per
    candidate: values and gradients."""
    rects, effs, cond, folded = folded_scene
    rng = np.random.default_rng(8)
    idx = np.array([0, 1, 2])
    if kind == "mixed":
        probs, is_star, width = np.repeat(idx, 2), [True, False] * 3, 7
    else:
        probs, is_star, width = idx, None, 3 if kind == "star" else 7
    rows = np.repeat(probs, 4)
    x = rects[rows][:, :width]
    x = (x + 0.02 * rng.normal(size=x.shape)).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    val = cond.logdensity(kind, probs, folded, is_star=is_star)(xt)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    row_star = (np.repeat(is_star, 4) if kind == "mixed"
                else np.full(len(rows), kind == "star"))
    for star in (True, False):
        sel = np.flatnonzero(row_star == star)
        if not len(sel):
            continue
        w = 3 if star else 7
        f = jax_run["m"].cond_logd("star" if star else "galaxy")
        jv, jg = jax.jit(jax.vmap(jax.value_and_grad(lambda v, e: f(v, [e]))))(
            jnp.asarray(x[sel, :w]), jnp.asarray(effs[rows[sel]]))
        np.testing.assert_allclose(val[sel].detach().numpy(), np.asarray(jv), **EVIDENCE_TOL)
        np.testing.assert_allclose(grad[sel, :w].numpy(), np.asarray(jg), rtol=5e-4, atol=0.1)
        assert torch.all(grad[sel, w:] == 0)


def test_empty_field():
    """No source above threshold -> empty catalog, no crash."""
    scene = make_synthetic_stamp([star_source(flux_r=0.01)], shape=(21, 21), bands=(2,), seed=7)
    catalog, artifacts = tpipe.run_pipeline(port_stamp(scene.stamps[0]), band=0, n_bands=1,
                                            cfg=tpipe.PipelineConfig(detection_snr_min=8.0),
                                            priors=T_PRIORS)
    assert catalog == [] and artifacts["n_sources"] == 0


def test_run_experiment_pipeline_on_the_cpu(monkeypatch, tmp_path):
    """``run_experiment`` of the ``pipeline`` config with ``ppc=true``,
    cut (three detection rounds, short MAP fits and type switch, a few NUTS
    steps), on the CPU; it needs CUDA for the default device."""
    monkeypatch.setattr(tpipe, "PipelineConfig",
                        functools.partial(tpipe.PipelineConfig, max_sources=3, map_steps=60,
                                          type_switch_steps=4, sampler="nuts", max_depth=2))
    cfg = copy.deepcopy(CONFIGS["pipeline"])
    cfg.device, cfg.ppc, cfg.out = "cpu", True, str(tmp_path / "pipe")
    cfg.n_chains, cfg.n_warmup, cfg.n_steps = 4, 8, 12
    res = run_experiment(cfg)
    n = len(res["kinds"])
    assert n >= 1 and res["du_mean"].shape == (n, 2) and res["flux_mean"].shape == (n, 1)
    assert res["ppc_pvalue"].shape == (1,) and 0.0 <= float(res["ppc_pvalue"][0]) <= 1.0
    assert len(res["run"]["catalog"]) == n
    with np.load(cfg.out + ".npz") as saved:
        assert list(saved["kinds"]) == list(res["kinds"])
    if not torch.cuda.is_available():
        cfg.device = "cuda"
        with pytest.raises(RuntimeError, match="needs CUDA"):
            run_experiment(cfg)


def _entry(module, du, flux, kind="star", du_std=0.05, flux_std_frac=0.05):
    flux = np.atleast_1d(np.asarray(flux, np.float64))
    return module.CatalogEntry(kind=kind, p_star=1.0 if kind == "star" else 0.0,
                               du_mean=np.asarray(du, np.float64), du_std=np.full(2, du_std),
                               flux_mean=flux, flux_std=flux_std_frac * flux)


def _ref(du, flux, kind="star"):
    return {"du": np.asarray(du, np.float64), "flux": np.atleast_1d(np.asarray(flux, np.float64)),
            "kind": kind}


def _calibrated(module):
    rng = np.random.default_rng(7)
    ref, cat = [], []
    for i in range(200):
        du = np.array([10.0 * (i % 20), 10.0 * (i // 20)])
        flux = np.array([25.0, 40.0])
        ref.append(_ref(du, flux))
        cat.append(module.CatalogEntry(kind="star", p_star=1.0,
                                       du_mean=du + rng.normal(size=2) * 0.05,
                                       du_std=np.full(2, 0.05),
                                       flux_mean=flux + rng.normal(size=2) * 0.04 * flux,
                                       flux_std=0.04 * flux))
    return cat, ref


# tests/test_catalog.py's cases: (catalog rows, reference rows, max_sep)
CATALOG_CASES = {
    "exact": (lambda m: [_entry(m, (3, -2), 12.0, kind="galaxy"), _entry(m, (0, 0), 30.0)],
              lambda: [_ref((0, 0), 30.0), _ref((3, -2), 12.0, kind="galaxy")], 1.0),
    "spurious_missed": (lambda m: [_entry(m, (0.1, 0.0), 28.0), _entry(m, (40, 40), 9.0)],
                        lambda: [_ref((0, 0), 30.0), _ref((5, 5), 20.0)], 1.0),
    "closest_pair": (lambda m: [_entry(m, (0.3, 0), 30.0), _entry(m, (0.05, 0), 30.0)],
                     lambda: [_ref((0, 0), 30.0), _ref((2.0, 0), 20.0)], 2.0),
    "calibrated": (lambda m: _calibrated(m)[0], lambda: _calibrated(jpipe)[1], 1.0),
    "zero_std": (lambda m: [_entry(m, (0.02, 0), 31.0, du_std=0.0, flux_std_frac=0.0)],
                 lambda: [_ref((0, 0), 30.0)], 1.0),
    "empty_catalog": (lambda m: [], lambda: [_ref((0, 0), 30.0)], 1.0),
    "empty_reference": (lambda m: [_entry(m, (0, 0), 30.0)], lambda: [], 1.0),
}


@pytest.mark.parametrize("case", list(CATALOG_CASES))
def test_catalog_accuracy_equals_jax(case):
    make_cat, make_ref, sep = CATALOG_CASES[case]
    want = jcat.catalog_accuracy(make_cat(jpipe), make_ref(), max_sep_arcsec=sep)
    got = tcat.catalog_accuracy(make_cat(tpipe), make_ref(), max_sep_arcsec=sep)
    assert got == want
    cat_du = [e.du_mean for e in make_cat(tpipe)] or np.zeros((0, 2))
    ref_du = [r["du"] for r in make_ref()] or np.zeros((0, 2))
    assert (tcat.match_catalogs(cat_du, ref_du, max_sep_arcsec=sep)
            == jcat.match_catalogs(cat_du, ref_du, max_sep_arcsec=sep))


def test_reference_rows_and_catalog_vs_truth_equal_jax(mixed_field):
    """``reference_from_sources`` on the field's truth, and the per-source
    pulls of a fabricated catalog (one row far from every source)."""
    jscene, tscene, srcs = mixed_field
    want = jcat.reference_from_sources(srcs, jscene.wcs, band_slots=[2])
    got = tcat.reference_from_sources(srcs, tscene.wcs, band_slots=[2])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["kind"] == w["kind"]
        assert np.array_equal(g["du"], w["du"]) and np.array_equal(g["flux"], w["flux"])
    rows = [(r["du"] + [0.05, -0.03], r["flux"] * 1.1) for r in want] + [((9.0, 9.0), [5.0])]
    j_rows = j_catalog_vs_truth([_entry(jpipe, du, f) for du, f in rows], srcs, jscene.wcs,
                                bands=[2])
    t_rows = catalog_vs_truth([_entry(tpipe, du, f) for du, f in rows], srcs, tscene.wcs,
                              bands=[2])
    assert [r["match"] for r in t_rows] == [r["match"] for r in j_rows]
    for t, j in zip(t_rows, j_rows):
        for key in ("du_pull", "flux_pull", "dist_arcsec"):
            if key in j:
                np.testing.assert_array_equal(t[key], j[key])
