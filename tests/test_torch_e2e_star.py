"""The config-1 slice end to end on the CPU: the port's star posterior, its
HMC trajectory and ``run_experiment("star_single")`` against the JAX
package on one scene.

Tolerances: log-densities rtol 2e-6, atol 0.5 (the kernel gate; the port
goes through the fused stamp likelihood, the JAX posterior renders
densely); gradients rtol 5e-4, atol 5e-2; a 10-step leapfrog trajectory
from one JAX warm state to atol 1e-5 arcsec / log-flux in position (under
1% of a posterior std). Posteriors compare in distribution, because the
random streams differ: means within 0.5 posterior std, stds within a factor
0.7-1.4 (the oracle-parity gate of tests/test_e2e_star.py), truth within
5 std, split R-hat < 1.1.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.inference import mh_init as j_mh_init, mh_kernel as j_mh_kernel
from celeste_tpu.inference import run_chains_ensemble as j_run
from celeste_tpu.inference.hmc import _leapfrog as j_leapfrog
from celeste_tpu.inference.problems import make_star_logdensity as j_make_logd
from celeste_tpu.inference.vg import value_and_grad_of
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors

from celeste_tpu_torch.experiments import CONFIGS, run_experiment
from celeste_tpu_torch.inference.hmc import _leapfrog as t_leapfrog
from celeste_tpu_torch.inference.problems import make_star_logdensity as t_make_logd
from celeste_tpu_torch.interop import hmc_warm_state_from_numpy
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors
from celeste_tpu_torch.run import main

from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

FLUX_R = 30.0
N_CHAINS, N_STEPS = 32, 1600


def _cfg(**overrides):
    cfg = copy.deepcopy(CONFIGS["star_single"])
    cfg.device = "cpu"
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def problem():
    """star_single's scene (seed 0) and its posterior in both packages."""
    src = star_source(u=(30.00005, 10.00008), flux_r=FLUX_R)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=0)
    j_logd = j_make_logd(scene.stamps, bands=[0], n_bands=1,
                         priors=JPriors(flux=JFlux(log_ref_mean=float(np.log(FLUX_R)),
                                                   log_ref_std=2.0)))
    t_logd = t_make_logd([port_stamp(scene.stamps[0])], bands=[0], n_bands=1,
                         priors=TPriors(flux=TFlux(log_ref_mean=float(np.log(FLUX_R)),
                                                   log_ref_std=2.0)))
    x_true = np.concatenate([scene.wcs.equa2duas(src["u"]),
                             [np.log(src["flux"][2])]]).astype(np.float32)
    return scene, j_logd, t_logd, x_true


def test_star_logdensity_matches_jax(problem):
    _, j_logd, t_logd, x_true = problem
    rng = np.random.default_rng(0)
    x = (x_true + rng.normal(size=(16, 3)) * np.float32([0.02, 0.02, 0.02])).astype(np.float32)
    want_v, want_g = jax.vmap(jax.value_and_grad(j_logd))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    got_v = t_logd(xt)
    (got_g,) = torch.autograd.grad(got_v.sum(), xt)
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(want_v), rtol=2e-6, atol=0.5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=5e-4, atol=5e-2)


def test_leapfrog_from_jax_warm_state(problem):
    """One warm chain state from the JAX package (x, logp, grad, step size,
    mass) fed to both leapfrog integrators with the same momentum."""
    _, j_logd, t_logd, x_true = problem
    rng = np.random.default_rng(1)
    x = (x_true + 0.005 * rng.normal(size=(8, 3))).astype(np.float32)
    logp, grad = jax.vmap(jax.value_and_grad(j_logd))(jnp.asarray(x))
    step = np.full(8, 0.3, np.float32)
    inv_mass = np.tile(np.float32([2.7e-5, 2.7e-5, 5.7e-5]), (8, 1))
    p = (rng.normal(size=(8, 3)) / np.sqrt(inv_mass)).astype(np.float32)
    vg = value_and_grad_of(j_logd)
    jx, jp, jlogp, _ = jax.vmap(
        lambda x_, p_, g_, s_, m_: j_leapfrog(vg, x_, p_, g_, s_, m_, 10))(
        jnp.asarray(x), jnp.asarray(p), grad, jnp.asarray(step), jnp.asarray(inv_mass))
    state, eps, im = hmc_warm_state_from_numpy(x, np.asarray(logp), np.asarray(grad), step,
                                               inv_mass)
    tx, tp, tlogp, _ = t_leapfrog(t_logd, state.x, torch.as_tensor(p), state.grad,
                                  eps[:, None], im, 10)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=2e-6, atol=0.5)


@pytest.fixture(scope="module")
def port_run():
    return run_experiment(_cfg(n_chains=N_CHAINS, n_steps=N_STEPS))


def test_run_experiment_brackets_truth(port_run):
    res = port_run
    assert res["samples"].shape == (N_CHAINS, N_STEPS, 3)
    assert np.all(np.isfinite(res["samples"]))
    assert 0.1 < res["accept_rate"] < 0.6
    assert np.all(res["rhat"] < 1.1), res["rhat"]
    assert np.all(np.abs(res["mean"] - res["x0"]) < 5.0 * res["std"]), (res["mean"], res["std"])


def test_posterior_matches_jax_run(problem, port_run):
    """Same scene, same MH kernel settings, different random streams."""
    _, j_logd, _, x_true = problem
    k_i, k_r = jax.random.split(jax.random.key(0))
    x0 = jnp.asarray(x_true) + 0.01 * jax.random.normal(k_i, (N_CHAINS, 3))
    init = jax.vmap(lambda x: j_mh_init(x, j_logd))(x0)
    samples, _, _ = j_run(k_r, j_mh_kernel(j_logd, step_scales=jnp.full(3, 0.01)), init,
                          n_steps=N_STEPS)
    js = np.asarray(samples[:, N_STEPS // 4:]).reshape(-1, 3)
    ts = port_run["samples"][:, N_STEPS // 4:].reshape(-1, 3)
    jm, jsd, tm, tsd = js.mean(0), js.std(0), ts.mean(0), ts.std(0)
    assert np.all(np.abs(tm - jm) < 0.5 * np.maximum(jsd, tsd)), (tm, jm, tsd, jsd)
    assert np.all(tsd / jsd > 0.7) and np.all(tsd / jsd < 1.4), (tsd, jsd)


def test_hmc_run_on_cpu():
    res = run_experiment(_cfg(sampler="hmc", n_chains=16, n_warmup=100, n_steps=120,
                              n_leapfrog=8))
    assert res["step_size"] > 0 and res["accept_rate"] > 0.5
    assert np.all(res["rhat"] < 1.1)
    assert np.all(np.abs(res["mean"] - res["x0"]) < 5.0 * res["std"])


def test_cli_and_not_yet_ported_paths(tmp_path):
    out = str(tmp_path / "run")
    res = main(["config=star_single", "device=cpu", "n_chains=4", "n_steps=20", "thin=2",
                f"out={out}"])
    assert res["samples"].shape == (4, 10, 3)
    with np.load(out + ".npz") as saved:
        assert np.array_equal(saved["samples"], res["samples"])
    with open(out + ".metrics.jsonl") as fh:
        assert [json.loads(line)["event"] for line in fh] == ["start", "done"]
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["config=no_such_config", "device=cpu"])
    with pytest.raises(SystemExit, match="unknown config key"):
        main(["config=star_single", "no_such_key=8"])
    for bad in (dict(name="no_such_config"), dict(name="crowded_field", color_prior="gmm")):
        with pytest.raises(NotImplementedError):
            run_experiment(_cfg(**bad))
    for bad in (dict(sampler="tempered_slice"), dict(name="quasar_photoz", sampler="mh"),
                dict(n_steps=30, checkpoint_every=20)):
        with pytest.raises(ValueError):
            run_experiment(_cfg(**bad))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            run_experiment(_cfg(device="cuda"))
