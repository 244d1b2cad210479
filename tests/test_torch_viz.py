"""The port's plotting utilities (``celeste_tpu_torch/viz.py``) render from
the port's tensors: the plots of tests/test_model_select.py's viz smoke
(model against data, traces, marginals, photo-z) and of
tests/test_pipeline.py's catalog comparison, here from a port stamp, its
render and a port field catalog.  Given the same numbers, the port's
figures are pixel for pixel the JAX package's."""

import os

import numpy as np
import torch

import jax.numpy as jnp

from celeste_tpu import viz as jviz
from celeste_tpu.catalog import catalog_accuracy as j_catalog_accuracy

from celeste_tpu_torch import viz
from celeste_tpu_torch.catalog import catalog_accuracy, reference_from_sources
from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
from celeste_tpu_torch.model import expected_image
from celeste_tpu_torch.model.params import StarParams
from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)


def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_viz_smoke_from_port_tensors(tmp_path):
    src = star_source(u=(30.0, 10.0), flux_r=40.0)
    scene = make_synthetic_stamp([src], shape=(21, 21), bands=(2,), seed=43, device="cpu")
    stamp = scene.stamps[0]
    du = scene.wcs.equa2duas(src["u"])
    p = StarParams(u=torch.as_tensor(du, dtype=torch.float32),
                   flux=torch.as_tensor(src["flux"], dtype=torch.float32))
    lam = expected_image([p], stamp, band=2)
    assert torch.is_tensor(lam)
    viz.plot_model_vs_data(stamp, lam, path=str(tmp_path / "mvd.png"))
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.normal(size=(4, 100, 3)), dtype=torch.float32)
    viz.plot_traces(s, path=str(tmp_path / "tr.png"))
    viz.plot_marginals(s, truth=torch.zeros(3), path=str(tmp_path / "mg.png"))
    viz.plot_photo_z(torch.as_tensor(rng.uniform(0, 6, 500)), z_true=2.5,
                     path=str(tmp_path / "pz.png"))
    for f in ("mvd.png", "tr.png", "mg.png", "pz.png"):
        assert os.path.getsize(tmp_path / f) > 5000
    # the same numbers through the JAX package's functions draw the same pixels
    from types import SimpleNamespace

    jstamp = SimpleNamespace(counts=jnp.asarray(stamp.counts.numpy()))
    pairs = [(viz.plot_model_vs_data(stamp, lam), jviz.plot_model_vs_data(jstamp,
                                                                          lam.numpy())),
             (viz.plot_traces(s), jviz.plot_traces(s.numpy())),
             (viz.plot_marginals(s, truth=torch.zeros(3)),
              jviz.plot_marginals(s.numpy(), truth=np.zeros(3)))]
    for got, want in pairs:
        np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_catalog_match_plot_from_a_port_catalog(tmp_path):
    """tests/test_pipeline.py's comparison plot from a port field MAP scan of
    a two-star frame and the port's catalog report."""
    srcs = [star_source(u=(30.0 - 5 / 3600, 10.0 - 4 / 3600), flux_r=50.0),
            star_source(u=(30.0 + 6 / 3600, 10.0 + 5 / 3600), flux_r=35.0)]
    scene = make_synthetic_stamp(srcs, shape=(48, 48), bands=(2,), seed=5, device="cpu")
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    catalog, _ = run_field_pipeline(scene.stamps[0], band=0, n_bands=1,
                                    cfg=FieldConfig(sample=False, type_switch=False,
                                                    map_steps=100, classify_sweeps=2),
                                    priors=priors)
    ref = reference_from_sources(srcs, scene.wcs, band_slots=[2])
    rep = catalog_accuracy(catalog, ref, max_sep_arcsec=1.0)
    assert rep["completeness"] == 1.0 and rep["purity"] == 1.0
    fig = viz.plot_catalog_match(catalog, ref, rep, path=str(tmp_path / "cm.png"))
    assert os.path.getsize(tmp_path / "cm.png") > 5000
    want = jviz.plot_catalog_match(catalog, ref, j_catalog_accuracy(catalog, ref,
                                                                    max_sep_arcsec=1.0))
    np.testing.assert_array_equal(_pixels(fig), _pixels(want))
