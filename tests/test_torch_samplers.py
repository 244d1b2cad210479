"""The port's batch-major samplers and diagnostics on the CPU.

Samplers: the moment suites of tests/test_samplers.py on the same 3-D
correlated Gaussian (MH and HMC must recover its mean within 0.15 / 0.12
and its covariance within 0.35 / 0.3, with split R-hat < 1.1; warmup must
adapt step sizes into (0.05, 5) and the mass to the target variances
within rtol 0.6).  The random streams differ from JAX's, so these are
distributional checks.

Diagnostics: ``split_rhat``, ``ess`` and ``summarize`` against the JAX
package on the same numpy samples, float32 on both sides: rtol 1e-4
(FFTs and reductions of two libraries in float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celeste_tpu.inference import diagnostics as jdiag

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from celeste_tpu_torch.inference import (
    ess, hmc_init, hmc_kernel, hmc_warmup, hmc_warmup_finish, hmc_warmup_init,
    hmc_warmup_window, mh_init, mh_kernel, run_chains_ensemble, split_rhat, summarize,
)

COV = np.array([[2.0, 0.9, -0.4], [0.9, 1.0, 0.3], [-0.4, 0.3, 0.7]])
MEAN = np.array([1.0, -2.0, 0.5])
PREC = torch.as_tensor(np.linalg.inv(COV), dtype=torch.float32)
N_CHAINS = 16
DIAG_TOL = dict(rtol=1e-4, atol=1e-5)


def logdensity(x):
    d = x - torch.as_tensor(MEAN, dtype=torch.float32)
    return -0.5 * torch.einsum("bi,ij,bj->b", d, PREC, d)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _init_positions(seed):
    return (torch.as_tensor(MEAN, dtype=torch.float32)
            + torch.randn((N_CHAINS, 3), generator=_gen(seed)))


def _check_moments(samples, mean_tol, cov_tol):
    flat = samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=mean_tol)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=cov_tol)
    r = split_rhat(samples).numpy()
    assert np.all(r < 1.1), f"rhat={r}"


def test_mh_gaussian():
    kernel = mh_kernel(logdensity, step_scales=torch.full((3,), 0.8))
    init = mh_init(_init_positions(0), logdensity)
    samples, _, info = run_chains_ensemble(_gen(1), kernel, init, n_steps=4000)
    assert samples.shape == (N_CHAINS, 4000, 3)
    acc = float(info.accepted.float().mean())
    assert 0.1 < acc < 0.7, acc
    _check_moments(samples[:, 1000:], 0.15, 0.35)


def test_thinning_keeps_every_thin_th_state():
    kernel = mh_kernel(logdensity, step_scales=torch.full((3,), 0.8))
    init = mh_init(_init_positions(0), logdensity)
    full, last, _ = run_chains_ensemble(_gen(9), kernel, init, n_steps=30)
    thinned, last_t, info = run_chains_ensemble(_gen(9), kernel, init, n_steps=30, thin=3)
    assert thinned.shape == (N_CHAINS, 10, 3) and info.accepted.shape == (N_CHAINS, 10)
    torch.testing.assert_close(thinned, full[:, 2::3], rtol=0, atol=0)
    torch.testing.assert_close(last_t.x, last.x, rtol=0, atol=0)
    with pytest.raises(ValueError):
        run_chains_ensemble(_gen(9), kernel, init, n_steps=31, thin=3)


def test_hmc_gaussian():
    kernel = hmc_kernel(logdensity, step_size=0.4,
                        inv_mass=torch.as_tensor(np.diag(COV).copy(), dtype=torch.float32),
                        n_leapfrog=8)
    init = hmc_init(_init_positions(2), logdensity)
    samples, _, info = run_chains_ensemble(_gen(3), kernel, init, n_steps=2000)
    acc = float(info.accept_prob.mean())
    assert acc > 0.6, acc
    _check_moments(samples[:, 400:], 0.12, 0.3)


def test_hmc_warmup_adapts():
    _, step_sizes, inv_mass = hmc_warmup(_gen(4), logdensity, _init_positions(5),
                                         n_warmup=600, n_leapfrog=8)
    ss = step_sizes.numpy()
    assert ss.shape == (N_CHAINS,)
    assert np.all(ss > 0.05) and np.all(ss < 5.0), ss
    np.testing.assert_allclose(inv_mass.mean(0).numpy(), np.diag(COV), rtol=0.6)


def test_warmup_windows_equal_one_warmup():
    """Chaining windows over one generator is exactly the monolithic warmup."""
    x0 = _init_positions(6)
    whole = hmc_warmup(_gen(7), logdensity, x0, n_warmup=60, n_leapfrog=4)
    gen = _gen(7)
    carry = hmc_warmup_init(x0, logdensity)
    carry = hmc_warmup_window(gen, logdensity, carry, 25, n_warmup=60, n_leapfrog=4)
    carry = hmc_warmup_window(gen, logdensity, carry, 35, n_warmup=60, n_leapfrog=4)
    parts = hmc_warmup_finish(carry)
    torch.testing.assert_close(parts[0].x, whole[0].x, rtol=0, atol=0)
    torch.testing.assert_close(parts[1], whole[1], rtol=0, atol=0)
    torch.testing.assert_close(parts[2], whole[2], rtol=0, atol=0)


def _chains(seed, c=4, n=600, d=3):
    """Autocorrelated AR(1) chains with per-chain offsets, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = np.zeros((c, n, d))
    for t in range(1, n):
        x[:, t] = 0.8 * x[:, t - 1] + rng.normal(size=(c, d))
    return (x + rng.normal(scale=0.3, size=(c, 1, d))).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 600, 3), (3, 501, 1)])
def test_diagnostics_match_jax(shape):
    x = _chains(8, *shape)
    got = summarize(torch.as_tensor(x))
    want = jdiag.summarize(jnp.asarray(x))
    for k in ("mean", "std", "rhat", "ess"):
        np.testing.assert_allclose(np.atleast_1d(got[k].numpy()),
                                   np.atleast_1d(np.asarray(want[k])), **DIAG_TOL)
    x2 = x[..., 0]
    np.testing.assert_allclose(float(ess(torch.as_tensor(x2))), float(jdiag.ess(jnp.asarray(x2))),
                               **DIAG_TOL)
    np.testing.assert_allclose(split_rhat(torch.as_tensor(x2)).numpy(),
                               np.asarray(jdiag.split_rhat(jnp.asarray(x2))), **DIAG_TOL)


def test_ess_sanity():
    """ESS of iid samples ~ n; ESS of heavily autocorrelated samples << n."""
    rng = np.random.default_rng(0)
    iid = torch.as_tensor(rng.normal(size=(4, 1000)), dtype=torch.float32)
    assert float(ess(iid)) > 2000
    ar = np.zeros((4, 1000))
    for t in range(1, 1000):
        ar[:, t] = 0.95 * ar[:, t - 1] + rng.normal(size=4) * 0.1
    assert float(ess(torch.as_tensor(ar, dtype=torch.float32))) < 1000
