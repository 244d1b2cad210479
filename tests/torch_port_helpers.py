"""Shared helpers of the ``test_torch_*`` files: move one JAX-package scene
or source into the PyTorch port through ``celeste_tpu_torch.interop``, as
NumPy arrays, keep each module's torch ops on one thread, and run the
port's stamp pipeline's decision stages once per process."""

import copy
import functools
import io
import json

import numpy as np
import pytest
import torch

from celeste_tpu_torch.interop import (
    galaxy_params_from_numpy,
    stamp_from_numpy,
    star_params_from_numpy,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread: the suite runs several worker
    processes at once, and torch's default pool of one thread per core then
    oversubscribes the machine, slowing the many small ops of the samplers
    by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_stamp(jstamp, device="cpu"):
    """The port's Stamp holding the same arrays as a JAX-package Stamp."""
    return stamp_from_numpy(
        counts=np.asarray(jstamp.counts), sky=np.asarray(jstamp.sky),
        iota=np.asarray(jstamp.iota), mask=np.asarray(jstamp.mask),
        psf_w=np.asarray(jstamp.psf.w), psf_mu=np.asarray(jstamp.psf.mu),
        psf_cov=np.asarray(jstamp.psf.cov), wcs_A=np.asarray(jstamp.wcs_A),
        wcs_p0=np.asarray(jstamp.wcs_p0), band=int(jstamp.band), device=device)


def source_base_vector(scene, kind):
    """The true unconstrained vector of a scene's first source (5 bands)."""
    src = scene.sources[0]
    parts = [scene.wcs.equa2duas(src["u"]), np.log(src["flux"])]
    if kind == "galaxy":
        t, ab = src["theta_dev"], src["ab"]
        parts.append([np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)),
                      src["phi"]])
    return np.concatenate(parts)


def source_vecs(scene, kind, n, scale, seed):
    """[n, D] float32 vectors scattered around the truth, drawn with numpy."""
    base = source_base_vector(scene, kind)
    rng = np.random.default_rng(seed)
    return (base[None, :] + scale * rng.normal(size=(n, base.size))).astype(np.float32)


def port_params(src, wcs, kind):
    """The port's params of an oracle-style source dict at its truth."""
    du = wcs.equa2duas(src["u"])
    if kind == "star":
        return star_params_from_numpy(du, src["flux"])
    return galaxy_params_from_numpy(du, src["flux"], src["theta_dev"], src["sigma"],
                                    src["ab"], src["phi"])


# tests/test_pipeline.py's settings, sampling cut to a few NUTS steps
PIPELINE_DECISION_CFG = dict(max_sources=5, map_steps=250, seed=3, detection_min_separation=7,
                             n_chains=2, n_warmup=4, n_steps=8, sampler="nuts", max_depth=2)


@functools.cache
def pipeline_decision_run():
    """The port's pipeline on tests/test_pipeline.py's ``mixed_field`` (the
    ``pipeline`` config's scene) at that file's detection and
    classification settings, the type switch off and the sampling cut to a
    few NUTS steps (``PIPELINE_DECISION_CFG``), with what its stages saw:
    each detection fit's start, residual and MAP; each sweep's candidate
    states before it, its results, and the states after its decisions.
    Run once per process: the pipeline test files share it, and must not
    change what it returns."""
    from celeste_tpu_torch import pipeline as tpipe
    from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    scene, srcs = pipeline_scene(CONFIGS["pipeline"], "cpu")
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    rec = {"det": [], "sweeps": []}
    det_fit = tpipe.Conditional.det_fit
    sweep, decide = tpipe.classify_sweep, tpipe.decide_sweep

    def det_fit_rec(self, x0, work, map_steps):
        x_map, lams = det_fit(self, x0, work, map_steps)
        rec["det"].append((x0.numpy().copy(), [w.copy() for w in work], x_map.numpy().copy()))
        return x_map, lams

    def sweep_rec(cond, cand, cfg):
        results = sweep(cond, cand, cfg)
        rec["sweeps"].append({"before": copy.deepcopy(cand), "results": results})
        return results

    def decide_rec(cand, results, cfg, n_bands):
        decide(cand, results, cfg, n_bands)
        rec["sweeps"][-1]["after"] = copy.deepcopy(cand)

    buf = io.StringIO()
    cfg = tpipe.PipelineConfig(type_switch=False, **PIPELINE_DECISION_CFG)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpipe.Conditional, "det_fit", det_fit_rec)
            mp.setattr(tpipe, "classify_sweep", sweep_rec)
            mp.setattr(tpipe, "decide_sweep", decide_rec)
            catalog, artifacts = tpipe.run_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg,
                                                    priors=priors,
                                                    logger=MetricsLogger(stream=buf))
    finally:
        torch.set_num_threads(n_threads)
    return {"rec": rec, "events": [json.loads(line) for line in buf.getvalue().splitlines()],
            "catalog": catalog, "artifacts": artifacts, "cfg": cfg, "scene": scene,
            "srcs": srcs, "priors": priors}
