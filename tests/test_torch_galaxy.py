"""The config-3 slice on the CPU: the single-galaxy posterior against the
JAX package, and ``galaxy`` through ``run_experiment``.

Tolerances: log-densities rtol 2e-6, atol 1.0 (the galaxy kernel gate of
tests/test_pallas_kernel.py: 48 components over 961 pixels summed in
another order; the port goes through the fused stamp likelihood, the JAX
posterior renders densely); gradients rtol 5e-4, atol 0.1 (the shape
coordinates' gradients reach ~1e3).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp
from celeste_tpu.inference.problems import make_galaxy_logdensity as j_make_logd
from celeste_tpu.model import color_prior as jcp
from celeste_tpu.model.priors import FluxPrior as JFlux, SourcePriors as JPriors

from celeste_tpu_torch.experiments import CONFIGS, run_experiment
from celeste_tpu_torch.inference.problems import make_galaxy_logdensity as t_make_logd
from celeste_tpu_torch.model import color_prior as tcp
from celeste_tpu_torch.model.priors import FluxPrior as TFlux, SourcePriors as TPriors

from torch_port_helpers import one_torch_thread, port_stamp, source_vecs  # noqa: F401 (autouse fixture)

FLUX_R = 60.0


def _logds(scene, bands, gmm):
    jgmm = jcp.default_galaxy_gmm() if gmm else None
    tgmm = tcp.default_galaxy_gmm() if gmm else None
    mean = float(np.log(FLUX_R))
    j = j_make_logd(scene.stamps, bands=bands, n_bands=len(bands),
                    priors=JPriors(flux=JFlux(log_ref_mean=mean, log_ref_std=2.0, color_gmm=jgmm)))
    t = t_make_logd([port_stamp(s) for s in scene.stamps], bands=bands, n_bands=len(bands),
                    priors=TPriors(flux=TFlux(log_ref_mean=mean, log_ref_std=2.0, color_gmm=tgmm)))
    return j, t


def _states(scene, bands):
    """8 states around the truth with the flux slots of ``bands`` only."""
    vecs = source_vecs(scene, "galaxy", 8, 0.03, seed=11)
    drop = [2 + b for b in range(5) if b not in bands]
    return np.delete(vecs, drop, axis=1)


@pytest.mark.parametrize("n_bands,gmm", [(1, False), (3, True)])
def test_galaxy_logdensity_matches_jax(n_bands, gmm):
    """Config 3 (one r-band 31x31 stamp), and a three-band galaxy with the
    galaxy colour mixture (marginalised onto two colours)."""
    src = galaxy_source(u=(30.0, 10.0), flux_r=FLUX_R)
    bands = (2,) if n_bands == 1 else (1, 2, 3)
    scene = make_synthetic_stamp([src], shape=(31, 31), bands=bands, seed=0)
    j_logd, t_logd = _logds(scene, list(range(n_bands)), gmm)
    vecs = _states(scene, bands)
    want = jax.jit(jax.vmap(j_logd))(jnp.asarray(vecs))
    want_g = jax.jit(jax.vmap(jax.grad(j_logd)))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    got = t_logd(x)
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-6, atol=1.0 * n_bands)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=5e-4, atol=0.1 * n_bands)


def test_run_experiment_galaxy():
    cfg = copy.deepcopy(CONFIGS["galaxy"])
    assert (cfg.sampler, cfg.n_chains, cfg.n_steps, cfg.shape, cfg.flux_r) == \
        ("nuts", 32, 800, (31, 31), 60.0)
    cfg.device, cfg.n_chains, cfg.n_warmup, cfg.n_steps, cfg.max_depth = "cpu", 4, 6, 8, 3
    res = run_experiment(cfg)
    assert res["samples"].shape == (4, 8, 7) and np.isfinite(res["samples"]).all()
    assert 0.0 <= res["divergence_rate"] <= 1.0 and 0.0 <= res["accept_rate"] <= 1.0
