"""The frozen reference against the program, on the CPU at a small size:
the dense posterior against the program's plain tiled path (value and
gradient, in x and in the whitened z), the whitening against the program's,
the renderer and the support radii against the program's, and the frozen
ESS and split-R-hat against the program's on seeded draws."""

import json

import numpy as np
import pytest
import torch

from skybench import catalog
from skybench.reference import diagnostics, renderer, support
from skybench.reference.field import make_field
from skybench.reference.posterior import DensePosterior
from skybench.reference.whiten import WhiteMap, pooled_moments
from skybench.scene import port_logdensity


def _field(name, seed=11):
    return make_field(catalog.load_json("configs", name), np.random.default_rng(seed))


@pytest.mark.parametrize("name", ["c5_r", "c5_gri"])
def test_dense_reference_matches_the_programs_plain_path(name):
    """Tolerances from the readings (0.033 and 0.052 nats, 1.5e-3 and 1.2e-3
    of the gradient): the tiled path drops the blocks past their support
    radius (< 1e-4 of a unit source each) and the two dead deV blocks,
    and sums in float32."""
    cfg = catalog.load_json("configs", name)
    f = make_field(cfg, np.random.default_rng(5))
    logd, _, truth = port_logdensity(f, cfg, "cpu")
    x = truth[None] + torch.as_tensor(0.01 * np.random.default_rng(0).normal(size=(4, f.dim)),
                                      dtype=torch.float32)
    xr = x.clone().requires_grad_(True)
    lp = logd(xr)
    (g,) = torch.autograd.grad(lp.sum(), xr)
    rlp, rg = DensePosterior(f, "cpu").value_and_grad(x.double())
    assert float((lp.detach().double() - rlp).abs().max()) < 0.25
    assert float(((g.double() - rg).norm(dim=1) / rg.norm(dim=1)).max()) < 5e-3


def test_whitened_reference_matches_the_programs_whitening():
    from celeste_tpu_torch.inference import ensemble_covariance, whiten_logdensity

    cfg = catalog.load_json("configs", "c5_r")
    f = make_field(cfg, np.random.default_rng(6))
    logd, _, truth = port_logdensity(f, cfg, "cpu")
    rng = np.random.default_rng(1)
    scale = 0.003 * (1.0 + rng.random(f.dim))
    draws = truth[None, None] + torch.as_tensor(scale * rng.normal(size=(64, 3, f.dim)),
                                                dtype=torch.float32)
    m, cov = ensemble_covariance(draws, ridge=1e-4)
    rm, rcov = pooled_moments(draws, 1e-4)
    assert torch.allclose(m.double(), rm, rtol=1e-6, atol=0)
    assert torch.allclose(cov.double(), rcov, rtol=1e-5, atol=1e-12)
    logd_z, to_x, _ = whiten_logdensity(logd, m, cov)
    z = torch.as_tensor(rng.normal(size=(4, f.dim)), dtype=torch.float32)
    wm = WhiteMap(rm, rcov)
    assert float((to_x(z).double() - wm.to_x(z.double())).abs().max()) < 1e-5
    zr = z.clone().requires_grad_(True)
    lp = logd_z(zr)
    (g,) = torch.autograd.grad(lp.sum(), zr)
    rlp, rg = DensePosterior(f, "cpu").value_and_grad(z.double(), wm.to_x)
    assert float((lp.detach().double() - rlp).abs().max()) < 0.25
    assert float(((g.double() - rg).norm(dim=1) / rg.norm(dim=1)).max()) < 5e-3


def test_renderer_and_support_match_the_program():
    from celeste_tpu_torch.model.galaxy import block_support_radii
    from celeste_tpu_torch.oracle.forward import oracle_scene_lambda

    cfg = catalog.load_json("configs", "c5_gri")
    f = _field("c5_gri")
    fld = cfg["field"]
    h, w = fld["shape"]
    a_deg = f.jac @ np.diag([3600.0 * np.cos(np.deg2rad(10.0)), 3600.0])
    ost = {"shape": (h, w), "sky": fld["sky"], "iota": fld["iota"],
           "wcs": {"A": a_deg, "u0": np.array([30.0, 10.0]), "p0": f.p0},
           "psf_w": f.psf_w[0], "psf_mu": np.zeros((3, 2)),
           "psf_cov": f.psf_var[0][:, None, None] * np.eye(2)}
    for i, band in enumerate(f.bands):
        srcs = []
        for s in cfg["sources"]:
            du = (np.array([s["x_px"], s["y_px"]]) - f.p0) * fld["pixel_scale_arcsec"]
            u = np.array([30.0 + du[0] / 3600.0 / np.cos(np.deg2rad(10.0)),
                          10.0 + du[1] / 3600.0])
            o = {"type": s["kind"], "u": u, "flux": s["flux_nmgy"][band]}
            if s["kind"] == "galaxy":
                o.update(theta_dev=s["theta_dev"], sigma=s["sigma_arcsec"], ab=s["ab"],
                         phi=s["phi"])
            srcs.append(o)
        want = oracle_scene_lambda(srcs, ost)
        got = renderer.expected_counts(cfg["sources"], band, (h, w), fld["sky"], fld["iota"],
                                       f.psf_w[i], f.psf_var[i], f.jac)
        assert np.max(np.abs(got - want) / want) < 1e-9
    radii = block_support_radii(f.kinds, psf_sigma_px=np.sqrt(f.psf_var.max()),
                                gal_sigma_px=1.2 / 0.396)
    assert np.array_equal(radii, f.radii)
    assert np.array_equal(support.block_support_radii(f.kinds, 1.5, 2.0, 1e-3, 1.0),
                          block_support_radii(f.kinds, 1.5, 2.0, 1e-3, 1.0))


def test_field_is_a_function_of_the_seed():
    a, b, c = _field("c5_r", 2 ** 31 + 5), _field("c5_r", 2 ** 31 + 5), _field("c5_r", 6)
    assert np.array_equal(a.counts, b.counts) and not np.array_equal(a.counts, c.counts)
    assert np.array_equal(a.truth, c.truth) and a.dim == 44 and _field("c5_gri").dim == 68


@pytest.mark.parametrize("shape", [(64, 40, 3), (5, 9, 2), (3, 64)])
def test_frozen_diagnostics_match_the_programs(shape):
    from celeste_tpu_torch.inference.diagnostics import ess, split_rhat

    rng = np.random.default_rng(sum(shape))
    x = np.cumsum(rng.normal(size=shape), axis=1) * 0.1 + rng.normal(size=shape)
    t = torch.as_tensor(x, dtype=torch.float64)
    assert torch.equal(diagnostics.ess(t), ess(t))
    assert torch.equal(diagnostics.split_rhat(t), split_rhat(t))
