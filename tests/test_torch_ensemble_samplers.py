"""The port's ensemble samplers on the CPU: NUTS, ChEES-HMC and the
dense-metric whitening (``celeste_tpu_torch.inference``).

Moment suites: the analytic targets of tests/test_samplers.py:85 (NUTS) and
tests/test_chees.py:33 (ChEES), with their gates (mean within 0.12,
covariance within 0.3, split R-hat < 1.1).  The random streams differ from
JAX's, so sampler outputs compare in distribution: NUTS against the JAX
NUTS on the same target, step size and mass (mean tree depth within 0.15,
each depth's share within 0.06, mean acceptance within 0.04, moments within
the suite's gates).  Deterministic pieces compare exactly or to float32:
the Halton jitter bitwise, the pooled covariance rtol 1e-5 against JAX and
2e-4 against NumPy, the whitening maps rtol 1e-5, the round trip 2e-4
(tests/test_whiten.py).  Windowed warmups and segmented runs compose
bitwise on one generator.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.inference import ensemble_covariance as j_cov
from celeste_tpu.inference import hmc_init as j_hmc_init, nuts_kernel as j_nuts
from celeste_tpu.inference import run_chains_ensemble as j_run
from celeste_tpu.inference import whiten_logdensity as j_whiten
from celeste_tpu.inference.chees import _halton as j_halton

from celeste_tpu_torch.bench.config5 import (
    config5_warmup_and_whiten, measure_chees_z, measure_nuts_z,
)
from celeste_tpu_torch.experiments import CONFIGS, run_experiment
from celeste_tpu_torch.inference import (
    chees_init, chees_warmup, chees_warmup_finish, chees_warmup_init, chees_warmup_window,
    ensemble_covariance, hmc_init, nuts_kernel, run_chains_ensemble, run_chees_ensemble,
    split_rhat, whiten_logdensity, whitened_chees_run,
)
from celeste_tpu_torch.inference.chees import _halton

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

COV = np.array([[2.0, 0.9, -0.4], [0.9, 1.0, 0.3], [-0.4, 0.3, 0.7]])
MEAN = np.array([1.0, -2.0, 0.5])
PREC = np.linalg.inv(COV)


def logdensity(x):
    d = x - torch.as_tensor(MEAN, dtype=torch.float32)
    return -0.5 * torch.einsum("bi,ij,bj->b", d, torch.as_tensor(PREC, dtype=torch.float32), d)


def j_logdensity(x):
    d = x - jnp.asarray(MEAN, jnp.float32)
    return -0.5 * d @ jnp.asarray(PREC, jnp.float32) @ d


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _x0(n, seed):
    rng = np.random.default_rng(seed)
    return (MEAN + rng.normal(size=(n, 3))).astype(np.float32)


def _check_moments(samples, mean_tol=0.12, cov_tol=0.3):
    flat = np.asarray(samples).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=mean_tol)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=cov_tol)
    r = split_rhat(torch.as_tensor(np.array(samples))).numpy()
    assert np.all(r < 1.1), r


def test_nuts_gaussian():
    inv_mass = torch.as_tensor(np.diag(COV).copy(), dtype=torch.float32)
    kernel = nuts_kernel(logdensity, step_size=0.5, inv_mass=inv_mass, max_depth=6)
    init = hmc_init(torch.as_tensor(_x0(32, 3)), logdensity)
    samples, _, info = run_chains_ensemble(_gen(4), kernel, init, n_steps=250)
    assert samples.shape == (32, 250, 3)
    assert not bool(info.diverged.any()), "NUTS diverged on a Gaussian"
    assert float(info.tree_depth.float().mean()) >= 1.0
    # every chain ran whole doubling rounds: 2^k - 1 leapfrog steps, k <= max_depth
    n = info.n_leapfrog.numpy()
    assert np.all(np.isin(n, [2 ** k - 1 for k in range(1, 7)])), np.unique(n)
    assert int(info.tree_depth.max()) <= 6
    _check_moments(samples[:, 50:])


def test_nuts_matches_jax_in_distribution():
    """Tree depth, leapfrog count and acceptance of the batch-major NUTS
    (finished chains masked) against the JAX NUTS (finished chains skipped
    per chain) on the same correlated Gaussian, step size and mass."""
    b, n = 64, 150
    x0 = _x0(b, 5)
    inv_mass = np.diag(COV).astype(np.float32)
    jk = j_nuts(j_logdensity, step_size=0.6, inv_mass=jnp.asarray(inv_mass), max_depth=6)
    jinit = jax.vmap(lambda x: j_hmc_init(x, j_logdensity))(jnp.asarray(x0))
    js, _, jinfo = jax.jit(lambda k, s: j_run(k, jk, s, n_steps=n))(jax.random.key(6), jinit)
    tk = nuts_kernel(logdensity, step_size=0.6, inv_mass=torch.as_tensor(inv_mass), max_depth=6)
    ts, _, tinfo = run_chains_ensemble(_gen(6), tk, hmc_init(torch.as_tensor(x0), logdensity),
                                       n_steps=n)
    jd = np.asarray(jinfo.tree_depth)[:, 20:].ravel()
    td = tinfo.tree_depth.numpy()[:, 20:].ravel()
    assert abs(jd.mean() - td.mean()) < 0.15, (jd.mean(), td.mean())
    for depth in range(7):
        assert abs(np.mean(jd == depth) - np.mean(td == depth)) < 0.06, depth
    ja = float(np.asarray(jinfo.accept_prob)[:, 20:].mean())
    ta = float(tinfo.accept_prob[:, 20:].mean())
    assert abs(ja - ta) < 0.04, (ja, ta)
    assert not bool(tinfo.diverged.any()) and not bool(np.asarray(jinfo.diverged).any())
    _check_moments(ts[:, 30:])
    _check_moments(np.asarray(js)[:, 30:])


def test_chees_gaussian_moments():
    """Warmup + frozen-(eps, T) run recovers mean and covariance; chains mix."""
    state, eps, traj = chees_warmup(_gen(1), logdensity, torch.as_tensor(_x0(64, 0)),
                                    n_warmup=300)
    eps, traj = float(eps), float(traj)
    assert 0.01 < eps < 5.0 and eps <= traj, (eps, traj)
    samples, _, infos = run_chees_ensemble(_gen(2), logdensity, state, n_steps=600,
                                           step_size=eps, trajectory_length=traj)
    assert samples.shape == (64, 600, 3) and infos.accept_rate.shape == (600,)
    assert float(infos.accept_rate.mean()) > 0.5
    assert float(infos.divergence_rate.max()) == 0.0
    _check_moments(samples[:, 150:])


def test_chees_trajectory_tracks_scale():
    """On N(0, s^2 I) the adapted trajectory grows with s."""
    trajs = {}
    for s in (0.25, 4.0):
        x0 = s * torch.as_tensor(np.random.default_rng(3).normal(size=(64, 3)), dtype=torch.float32)
        _, _, traj = chees_warmup(_gen(4), lambda x, s=s: -0.5 / (s * s) * torch.sum(x * x, -1),
                                  x0, n_warmup=400, init_step_size=0.1 * s)
        trajs[s] = float(traj)
    assert trajs[4.0] > 4.0 * trajs[0.25], trajs


def test_halton_matches_jax():
    idx = list(range(0, 300)) + [1023, 1024, 4095, 65535, 123456, (1 << 24) - 2, (1 << 24) + 5]
    want = np.asarray(jax.vmap(j_halton)(jnp.asarray(idx, jnp.int32)))
    got = np.asarray([float(_halton(i)) for i in idx], np.float32)
    assert np.array_equal(got, want)
    assert _halton(0).dtype == torch.float32


def test_chees_warmup_windows_compose_bitwise():
    x0 = torch.as_tensor(_x0(32, 6))
    st_m, eps_m, traj_m = chees_warmup(_gen(7), logdensity, x0, n_warmup=60)
    gen = _gen(7)
    carry = chees_warmup_init(x0, logdensity)
    carry = chees_warmup_window(gen, logdensity, carry, n_iters=25)
    carry = chees_warmup_window(gen, logdensity, carry, n_iters=35)
    st_w, eps_w, traj_w = chees_warmup_finish(carry)
    assert float(eps_m) == float(eps_w) and float(traj_m) == float(traj_w)
    assert torch.equal(st_m.xs, st_w.xs) and torch.equal(st_m.logps, st_w.logps)
    assert carry[1].log_eps.dtype == torch.float32


def test_run_chees_segments_compose_with_start_iter():
    st0 = chees_init(torch.as_tensor(_x0(5, 8)), logdensity)
    mono, st_m, info_m = run_chees_ensemble(_gen(9), logdensity, st0, n_steps=6, step_size=0.3,
                                            trajectory_length=1.0)
    gen = _gen(9)
    s1, st, i1 = run_chees_ensemble(gen, logdensity, st0, n_steps=4, step_size=0.3,
                                    trajectory_length=1.0, start_iter=0)
    s2, st, i2 = run_chees_ensemble(gen, logdensity, st, n_steps=2, step_size=0.3,
                                    trajectory_length=1.0, start_iter=4)
    assert torch.equal(torch.cat([s1, s2], dim=1), mono)
    assert torch.equal(st.xs, st_m.xs)
    assert torch.equal(torch.cat([i1.n_leapfrog, i2.n_leapfrog]), info_m.n_leapfrog)


def test_ensemble_covariance_matches_numpy_and_jax():
    rng = np.random.default_rng(1)
    xs = (rng.normal(size=(256, 5)) * [1, 2, 3, 4, 5]).astype(np.float32)
    m, cov = ensemble_covariance(torch.as_tensor(xs), ridge=0.0)
    np.testing.assert_allclose(m.numpy(), xs.mean(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.cov(xs.T), rtol=2e-4, atol=2e-4)
    for ridge in (0.0, 1e-4):
        jm, jc = j_cov(jnp.asarray(xs.reshape(16, 16, 5)), ridge=ridge)
        tm, tc = ensemble_covariance(torch.as_tensor(xs.reshape(16, 16, 5)), ridge=ridge)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def _correlated_gaussian(d=6, rho=0.97, seed=0):
    """tests/test_whiten.py's strongly correlated, badly scaled Gaussian."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)).astype(np.float32)
    cov = a @ a.T + d * np.eye(d, dtype=np.float32)
    s = np.sqrt(np.diagonal(cov))
    corr = (1 - rho) * (cov / np.outer(s, s)) + rho * np.ones((d, d), np.float32)
    np.fill_diagonal(corr, 1.0)
    scales = np.geomspace(0.05, 20.0, d).astype(np.float32)
    cov = corr * np.outer(scales, scales)
    mean = rng.normal(size=d).astype(np.float32)
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float64)

    def logd(x):
        diff = (x - torch.as_tensor(mean)).double()
        return (-0.5 * torch.einsum("bi,ij,bj->b", diff, prec, diff)).float()

    return logd, mean, cov


def test_whiten_roundtrip_isotropy_and_maps_match_jax():
    logd, mean, cov = _correlated_gaussian()
    logd_z, to_x, to_z = whiten_logdensity(logd, torch.as_tensor(mean), torch.as_tensor(cov))
    z = torch.as_tensor(np.random.default_rng(2).normal(size=(7, 6)), dtype=torch.float32)
    torch.testing.assert_close(to_z(to_x(z)), z, rtol=2e-4, atol=2e-4)
    expected = -0.5 * torch.sum(z * z, dim=1)
    torch.testing.assert_close(logd_z(z), expected, rtol=2e-3, atol=2e-3)
    _, j_to_x, j_to_z = j_whiten(lambda x: jnp.sum(x), mean, cov)
    x = to_x(z)
    np.testing.assert_allclose(x.numpy(), np.asarray(j_to_x(jnp.asarray(z.numpy()))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_z(x).numpy(), np.asarray(j_to_z(jnp.asarray(x.numpy()))),
                               rtol=1e-4, atol=1e-4)
    # leading batch axes pass through both maps
    assert to_x(z.reshape(7, 1, 6)).shape == (7, 1, 6)


def test_whitened_chees_run_recovers_correlated_gaussian():
    logd, mean, cov = _correlated_gaussian()
    rng = np.random.default_rng(4)
    probe = torch.as_tensor(rng.multivariate_normal(mean, cov, size=(64, 8)), dtype=torch.float32)
    states = torch.as_tensor(rng.multivariate_normal(mean, cov, size=64), dtype=torch.float32)
    samples, infos, aux = whitened_chees_run(_gen(5), logd, probe, states, n_warmup=100,
                                             n_steps=200)
    assert samples.shape == (64, 200, 6) and float(infos.accept_rate.mean()) > 0.5
    flat = samples[:, 50:].reshape(-1, 6).double().numpy()
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(flat.mean(0), mean, atol=0.1 * sd.max())
    np.testing.assert_allclose(flat.std(0) / sd, np.ones(6), atol=0.15)


def test_config5_flow_on_a_gaussian():
    """The config-5 flow (diagonal warmup -> NUTS probe -> dense metric ->
    z-space warmup -> ChEES arm, NUTS arm) at a few chains and steps on the
    correlated Gaussian, with the gates of the card's config-5 run: finite
    draws, ChEES accept >= 0.4, divergence <= 0.05 and split R-hat <= 1.1 in
    both arms.  The pooled metric (64 chains x 8 probe draws) lies within
    0.25 of the target's moments, and the maps invert each other to 1e-5."""
    prep = config5_warmup_and_whiten(logdensity, torch.as_tensor(MEAN, dtype=torch.float32),
                                     n_chains=64, n_warmup=100, n_zwarm=20, probe_steps=8)
    m_hat, cov_hat = prep["whiten_moments"]
    np.testing.assert_allclose(m_hat.numpy(), MEAN, atol=0.25)
    np.testing.assert_allclose(cov_hat.numpy(), COV, atol=0.25)
    z = prep["states_z"].x
    torch.testing.assert_close(prep["to_z"](prep["to_x"](z)), z, rtol=0, atol=1e-5)
    chees = measure_chees_z(prep, n_steps=120, run_segment=40, warmup_iters=40)
    nuts = measure_nuts_z(prep, n_steps=32, run_segment=16)
    assert chees["accept"] >= 0.4 and 0.0 < chees["eps"] <= chees["traj"]
    for arm in (chees, nuts):
        assert arm["finite"] and arm["divergence"] <= 0.05 and arm["max_rhat"] <= 1.1, arm
        assert arm["ess"].shape == arm["rhat"].shape == (3,)


def test_chees_and_nuts_through_run_experiment():
    """sampler=chees (and nuts) with metric=dense flow through the entry
    point (warmup -> probe -> whitening -> sampler) on the star posterior,
    as tests/test_chees.py::test_chees_via_experiment_runner does."""
    cfg = copy.deepcopy(CONFIGS["star_single"])
    for k, v in dict(device="cpu", sampler="chees", n_chains=8, n_steps=160, n_warmup=60,
                     metric="dense", shape=(15, 15)).items():
        setattr(cfg, k, v)
    r = run_experiment(cfg)
    assert float(np.max(r["rhat"])) < 1.1
    assert float(np.min(r["ess"])) > 50.0
    assert np.all(np.abs(r["mean"] - r["x0"]) < 5.0 * r["std"])
    cfg.sampler, cfg.n_steps, cfg.max_depth = "nuts", 40, 4
    r = run_experiment(cfg)
    assert float(np.max(r["rhat"])) < 1.1 and r["divergence_rate"] == 0.0
    with pytest.raises(ValueError, match="thinning"):
        run_experiment(dataclasses.replace(cfg, sampler="chees", thin=2))
