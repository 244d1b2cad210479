"""The config-2 slice on the CPU: five-band stamps, the colour prior, the
multi-band star posterior, the slice sampler and ``star_ugriz`` through
``run_experiment``, against the JAX package.

Tolerances:
- ``stack_stamps``, the default colour mixtures and the carried mixture:
  exact (the same arrays; the same NumPy EM);
- ``ColorGMM.logpdf``: rtol 1e-5, atol 1e-5 (float32 logsumexp in two
  libraries); ``FluxPrior.logpdf``, whose terms reach ~10: atol 1e-4;
- the five-band star log-likelihood per band: values rtol 2e-6 + atol 0.5,
  gradients rtol 5e-4 + atol 5e-2 (the kernel gates; the port goes through
  the fused stamp likelihood, the JAX posterior renders densely); the whole
  log-density, five bands summed: atol 5 x 0.5 and 5 x 5e-2;
- the slice sampler, in distribution (the random streams differ): the
  3-D Gaussian moment gate of tests/test_samplers.py (mean atol 0.12,
  covariance atol 0.3, split R-hat < 1.1) and the 1-D flux posterior of
  tests/test_statistical_validity.py against quadrature (mean within 3 MC
  standard errors, sd within 10%).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.inference.problems import make_star_logdensity as j_make_logd
from celeste_tpu.likelihood import stamp_loglik as j_stamp_loglik
from celeste_tpu.model import color_prior as jcp
from celeste_tpu.model.params import StarParams as JStarParams
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors
from celeste_tpu.model.stamp import stack_stamps as j_stack_stamps

from celeste_tpu_torch.experiments import CONFIGS, run_experiment
from celeste_tpu_torch.inference import run_chains_ensemble, slice_init, slice_kernel, split_rhat
from celeste_tpu_torch.inference.problems import make_star_logdensity as t_make_logd
from celeste_tpu_torch.interop import color_gmm_from_fields
from celeste_tpu_torch.kernels import mog_field as tmf
from celeste_tpu_torch.model import color_prior as tcp
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors
from celeste_tpu_torch.model.stamp import stack_stamps as t_stack_stamps

from torch_port_helpers import one_torch_thread, port_stamp, source_vecs  # noqa: F401 (autouse fixture)

TOL = dict(rtol=2e-6, atol=0.5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)
PRIOR_TOL = dict(rtol=1e-5, atol=1e-5)
BANDS = (0, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def ugriz():
    """star_ugriz's scene (seed 0): one star, five 25x25 stamps."""
    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=BANDS, seed=0)
    return scene, [port_stamp(s) for s in scene.stamps]


def test_stack_stamps_matches_jax(ugriz):
    scene, tstamps = ugriz
    want = j_stack_stamps(scene.stamps)
    got = t_stack_stamps(tstamps)
    for name in ("counts", "sky", "iota", "mask", "wcs_A", "wcs_p0", "band"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    for name in ("w", "mu", "cov"):
        assert np.array_equal(getattr(got.psf, name).numpy(), np.asarray(getattr(want.psf, name)))
    assert tuple(got.counts.shape) == (5, 25, 25)


def _colors(n, c, seed):
    return np.random.default_rng(seed).normal([-0.8, -0.4, -0.15, -0.05][:c], 0.3,
                                              size=(n, c)).astype(np.float32)


@pytest.mark.parametrize("which", ["star", "galaxy"])
def test_default_color_mixtures_equal_jax(which):
    want = getattr(jcp, f"default_{which}_gmm")()
    got = getattr(tcp, f"default_{which}_gmm")()
    assert (got.weights, got.means, got.inv_chols) == (want.weights, want.means, want.inv_chols)
    assert got.n_comp == 4 and got.n_dim == 4


@pytest.mark.parametrize("n_colors", [4, 2])   # 2: marginalised onto the leading colours
def test_color_gmm_logpdf_matches_jax(n_colors):
    colors = _colors(64, n_colors, seed=n_colors)
    for which in ("star", "galaxy"):
        want = getattr(jcp, f"default_{which}_gmm")().logpdf(jnp.asarray(colors))
        got = getattr(tcp, f"default_{which}_gmm")().logpdf(torch.as_tensor(colors))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIOR_TOL)


def test_color_gmm_carried_across_gives_the_same_logpdf():
    j = jcp.default_star_gmm()
    carried = color_gmm_from_fields(np.asarray(j.weights), np.asarray(j.means),
                                    np.asarray(j.inv_chols))
    assert carried == tcp.default_star_gmm()
    colors = _colors(32, 4, seed=9)
    np.testing.assert_allclose(carried.logpdf(torch.as_tensor(colors)).numpy(),
                               np.asarray(j.logpdf(jnp.asarray(colors))), **PRIOR_TOL)


def test_flux_prior_with_color_gmm_matches_jax():
    log_flux = (np.log([9.0, 21.0, 30.0, 34.5, 36.0])
                + 0.2 * np.random.default_rng(3).normal(size=(16, 5))).astype(np.float32)
    want = JFlux(log_ref_mean=3.4, log_ref_std=2.0,
                 color_gmm=jcp.default_star_gmm()).logpdf(jnp.asarray(log_flux))
    got = TFlux(log_ref_mean=3.4, log_ref_std=2.0,
                color_gmm=tcp.default_star_gmm()).logpdf(torch.as_tensor(log_flux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def _states(scene, n=8):
    return source_vecs(scene, "star", n, 0.02, seed=5)


@pytest.mark.parametrize("band", BANDS)
def test_each_band_matches_jax(ugriz, band):
    scene, tstamps = ugriz
    vecs = _states(scene)
    jstamp = scene.stamps[band]

    def j_ll(v):
        return j_stamp_loglik([JStarParams.from_vector(v, 5)], jstamp, band=band)

    want = jax.jit(jax.vmap(j_ll))(jnp.asarray(vecs))
    want_g = jax.jit(jax.vmap(jax.grad(j_ll)))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    got = tmf.batched_stamp_loglik(x, tstamps[band], band=band, kind="star", n_bands=5)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("color_prior", ["gaussian", "gmm"])
def test_five_band_star_logdensity_matches_jax(ugriz, color_prior):
    scene, tstamps = ugriz
    vecs = _states(scene)
    gmm = color_prior == "gmm"
    j_priors = JPriors(flux=JFlux(log_ref_mean=float(np.log(30.0)), log_ref_std=2.0,
                                  color_gmm=jcp.default_star_gmm() if gmm else None))
    t_priors = TPriors(flux=TFlux(log_ref_mean=float(np.log(30.0)), log_ref_std=2.0,
                                  color_gmm=tcp.default_star_gmm() if gmm else None))
    j_logd = j_make_logd(scene.stamps, bands=list(BANDS), priors=j_priors, n_bands=5)
    t_logd = t_make_logd(tstamps, bands=list(BANDS), priors=t_priors, n_bands=5)
    want = jax.jit(jax.vmap(j_logd))(jnp.asarray(vecs))
    want_g = jax.jit(jax.vmap(jax.grad(j_logd)))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    got = t_logd(x)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-6, atol=5 * 0.5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=5e-4, atol=5 * 5e-2)


# ---------------------------------------------------------------------------
# the slice sampler
# ---------------------------------------------------------------------------

COV = np.array([[2.0, 0.9, -0.4], [0.9, 1.0, 0.3], [-0.4, 0.3, 0.7]])
MEAN = np.array([1.0, -2.0, 0.5])
PREC = torch.as_tensor(np.linalg.inv(COV), dtype=torch.float32)


def _gaussian(x):
    d = x - torch.as_tensor(MEAN, dtype=torch.float32)
    return -0.5 * torch.sum(d * (d @ PREC), dim=-1)


def test_slice_gaussian():
    gen = torch.Generator().manual_seed(1)
    x0 = torch.as_tensor(MEAN, dtype=torch.float32) + torch.randn((16, 3), generator=gen)
    kernel = slice_kernel(_gaussian, widths=torch.full((3,), 2.0))
    samples, _, info = run_chains_ensemble(gen, kernel, slice_init(x0, _gaussian), n_steps=1500)
    flat = samples[:, 300:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.12)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.3)
    assert np.all(split_rhat(samples[:, 300:]).numpy() < 1.1)
    # every chain's evaluations fit in the sweep's batched calls
    assert bool((info.n_evals <= info.n_calls + 3).all())
    assert bool((info.n_evals >= 3 * 4).all())   # >= 1 + 1 + 1 + 1 per coordinate


def test_slice_flux_posterior_matches_quadrature():
    src = star_source(u=(30.0, 10.0), flux_r=25.0)
    scene = make_synthetic_stamp([src], shape=(15, 15), bands=(2,), seed=71)
    stamp = port_stamp(scene.stamps[0])
    du = torch.as_tensor(scene.wcs.equa2duas(src["u"]), dtype=torch.float32)
    prior_mu, prior_sd = np.log(25.0), 1.0

    def logpost(x):
        vecs = torch.cat([du.expand(x.shape[0], 2), x[:, :1]], dim=1)
        ll = tmf.batched_stamp_loglik(vecs, stamp, band=0, kind="star", n_bands=1)
        return ll - 0.5 * ((x[:, 0] - prior_mu) / prior_sd) ** 2

    grid = np.linspace(prior_mu - 0.6, prior_mu + 0.6, 4001)
    logp = logpost(torch.as_tensor(grid, dtype=torch.float32)[:, None]).double().numpy()
    wts = np.exp(logp - logp.max())
    wts /= wts.sum()
    mean_q = float(np.sum(wts * grid))
    sd_q = float(np.sqrt(np.sum(wts * (grid - mean_q) ** 2)))

    gen = torch.Generator().manual_seed(0)
    kern = slice_kernel(logpost, widths=torch.tensor([0.1]))
    x0 = torch.full((8, 1), prior_mu, dtype=torch.float32)
    samples, _, _ = run_chains_ensemble(gen, kern, slice_init(x0, logpost), n_steps=600)
    s = samples[:, 100:, 0].reshape(-1).double().numpy()
    mc_se = sd_q / np.sqrt(len(s) / 10.0)
    assert abs(s.mean() - mean_q) < 3 * mc_se + 1e-3, (s.mean(), mean_q)
    assert abs(s.std() / sd_q - 1.0) < 0.10, (s.std(), sd_q)


def test_slice_caps_and_masks():
    """On a flat density, chains whose slice level no point reaches (log y
    = 1e9) step out once per side, end at the shrinkage cap and keep their
    point; chains with log y = -inf step out to the cap and take the first
    proposal.  The phases run until the last chain is done: the done chains
    wait under their masks."""
    def flat(x):
        return torch.zeros(x.shape[0])

    gen = torch.Generator().manual_seed(2)
    x0 = torch.randn((6, 2), generator=gen)
    level = torch.tensor([1e9, -float("inf")] * 3)
    state = slice_init(x0, flat)._replace(logp=level)
    new, info = slice_kernel(flat, torch.ones(2), max_stepout=3, max_shrink=4)(gen, state)
    stuck, free = level > 0, level < 0
    assert torch.equal(new.x[stuck], x0[stuck]) and torch.equal(new.logp[stuck], level[stuck])
    assert bool((new.x[free] != x0[free]).all()) and bool((new.logp[free] == 0).all())
    # per coordinate: stuck 1 + 1 + 4 shrinks + 1; free 3 + 3 + 1 + 1; calls 3 + 3 + 4
    assert info.n_evals.tolist() == [2 * 7, 2 * 8] * 3
    assert bool((info.n_calls == 2 * 10).all())


# ---------------------------------------------------------------------------
# star_ugriz through the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,extra", [("hmc", {}), ("slice", {"color_prior": "gmm"})])
def test_run_experiment_star_ugriz(sampler, extra):
    cfg = copy.deepcopy(CONFIGS["star_ugriz"])
    assert (cfg.sampler, cfg.n_chains, cfg.n_steps, cfg.bands) == ("hmc", 32, 1000, BANDS)
    cfg.device, cfg.sampler, cfg.n_chains, cfg.n_warmup, cfg.n_steps = "cpu", sampler, 4, 10, 8
    for k, v in extra.items():
        setattr(cfg, k, v)
    res = run_experiment(cfg)
    assert res["samples"].shape == (4, 8, 7) and np.isfinite(res["samples"]).all()
    assert res["x0"].shape == (7,)
    if sampler == "slice":
        assert res["evals_per_sweep"] >= 7 * 4 and res["calls_per_sweep"] >= 7 * 3
    else:
        assert 0.0 <= res["accept_rate"] <= 1.0
