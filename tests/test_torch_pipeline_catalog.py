"""The catalog of the port's stamp pipeline, sampled, held to the JAX
package's own gates (tests/test_pipeline.py:38-96) on its ``mixed_field``
(two stars and a galaxy on a 33x33 stamp), and its posterior-predictive
check.

The run takes that file's detection and classification settings (five
rounds, 250-step MAP fits, three sweeps, seed 3): its candidates after the
sweeps are those of ``torch_port_helpers.pipeline_decision_run``, which
tests/test_torch_pipeline.py holds against JAX's, and ``sample_catalog``
goes on from them with that file's 8 chains, cut in steps for the CPU: the
type switch to 10 steps of 4 chains (300 of 8), the sampling to 50 warmup
and 100 ChEES steps (150 and 250); on this CPU the full settings take
minutes in torch's eager plain stamp kernel.  The uncut run is a card test,
``test_pipeline_catalog_at_full_settings`` in
tests/test_torch_kernels_cuda.py.  The gates are the JAX file's,
unchanged; the PPC p-value must lie in (0.01, 0.99) (tests/test_pipeline.py's
calibrated-scene gate).
"""

import copy

import numpy as np
import pytest

from celeste_tpu_torch import pipeline as tpipe
from celeste_tpu_torch.catalog import catalog_accuracy, reference_from_sources

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse fixture)
    PIPELINE_DECISION_CFG,
    one_torch_thread,
    pipeline_decision_run,
)


@pytest.fixture(scope="module")
def mixed_field():
    run = pipeline_decision_run()
    return run["scene"], run["srcs"]


@pytest.fixture(scope="module")
def pipeline_result():
    run = pipeline_decision_run()
    last = run["rec"]["sweeps"][-1]
    settings = dict(PIPELINE_DECISION_CFG, n_chains=8, n_warmup=50, n_steps=100,
                    sampler="chees", type_switch_steps=10, type_switch_chains=4, ppc=True)
    cond = tpipe.Conditional(run["scene"].stamps, [0], 1, run["priors"])
    return tpipe.sample_catalog(cond, copy.deepcopy(last["after"]), last["results"],
                                tpipe.PipelineConfig(**settings))


def test_detects_all_sources(pipeline_result):
    _, artifacts = pipeline_result
    assert artifacts["n_sources"] == 3
    assert artifacts["samples"].shape == (8, 100, 3 + 3 + 7)
    assert np.isfinite(artifacts["samples"]).all()


def test_classification(pipeline_result):
    catalog, _ = pipeline_result
    kinds = sorted(e.kind for e in catalog)
    assert kinds == ["galaxy", "star", "star"], [(e.kind, e.p_star) for e in catalog]


def test_catalog_accuracy_report(pipeline_result, mixed_field):
    """Perfect completeness, purity and classification; honest astrometry,
    photometry and posterior widths."""
    scene, srcs = mixed_field
    catalog, _ = pipeline_result
    rep = catalog_accuracy(catalog, reference_from_sources(srcs, scene.wcs, band_slots=[2]),
                           max_sep_arcsec=1.0)
    assert rep["completeness"] == 1.0 and rep["purity"] == 1.0
    assert rep["kind_accuracy"] == 1.0
    assert rep["pos_rms_arcsec"] < 0.2, rep["pos_rms_arcsec"]
    assert abs(rep["flux_rel_bias"]) < 0.2, rep["flux_rel_bias"]
    assert rep["pos_z_rms"] is not None and 0.05 < rep["pos_z_rms"] < 6.0
    assert rep["flux_z_rms"] is not None and 0.05 < rep["flux_z_rms"] < 6.0


def test_fluxes_recovered(pipeline_result, mixed_field):
    _, srcs = mixed_field
    catalog, _ = pipeline_result
    truth = sorted(s["flux"][2] for s in srcs)
    est = sorted(float(e.flux_mean[0]) for e in catalog)
    for t, e in zip(truth, est):
        assert abs(e - t) / t < 0.25, (truth, est)


def test_positions_recovered(pipeline_result, mixed_field):
    scene, srcs = mixed_field
    catalog, _ = pipeline_result
    truth = sorted(tuple(np.round(scene.wcs.equa2duas(s["u"]), 1)) for s in srcs)
    est = sorted(tuple(np.round(e.du_mean, 1)) for e in catalog)
    for t, e in zip(truth, est):
        assert np.hypot(t[0] - e[0], t[1] - e[1]) < 0.4, (truth, est)


def test_galaxy_shape_in_catalog(pipeline_result):
    catalog, _ = pipeline_result
    gal = [e for e in catalog if e.kind == "galaxy"][0]
    assert 0.5 < gal.extras["sigma_mean"] < 4.0
    assert 0.1 < gal.extras["ab_mean"] < 1.0


def test_ppc_calibrated(pipeline_result):
    _, artifacts = pipeline_result
    (check,) = artifacts["ppc"]
    assert 0.01 < check["pvalue"] < 0.99, check
