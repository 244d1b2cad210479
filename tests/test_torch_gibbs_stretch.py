"""Block Gibbs, red/black Gibbs and the stretch move of the port
(``celeste_tpu_torch/inference/gibbs.py``, ``ensemble_stretch.py``), held
to what the JAX package's tests hold its own to (tests/test_parallel.py:125,
:146, :196; tests/test_stretch_and_artifacts.py:22, :44), on the same
scenes, with each sampler's states carried from JAX by ``interop``.

Samplers match in distribution, not bitwise (the random streams differ):
every source block accepts > 5% of its proposals over 100 sweeps; the
stretch move's moments on a correlated Gaussian within atol 0.15 (mean) and
0.5 (covariance), and its acceptance within 0.05 under an affine map.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu.inference.ensemble_stretch import stretch_init as j_stretch_init
from celeste_tpu.inference.gibbs import color_sources as j_color_sources
from celeste_tpu.inference.gibbs import gibbs_init as j_gibbs_init
from celeste_tpu.parallel import CrowdedScene as JScene
from celeste_tpu.parallel import make_crowded_logdensity as j_crowded

from celeste_tpu_torch.inference import (
    block_gibbs_kernel,
    color_sources,
    colored_gibbs_kernel,
    stretch_init,
    stretch_kernel,
)
from celeste_tpu_torch.interop import gibbs_state_from_numpy, stretch_state_from_numpy
from celeste_tpu_torch.parallel.crowded import CrowdedScene, make_crowded_logdensity
from celeste_tpu_torch.utils.rng import seeded_generator

from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

COV = np.array([[4.0, 1.8], [1.8, 1.0]])   # strongly correlated, scale-split
MEAN = np.array([2.0, -1.0])
PREC = np.linalg.inv(COV)


@pytest.fixture(scope="module")
def crowded_scene():
    """tests/test_parallel.py's 4 stars in a 31x31 stamp, some overlapping."""
    srcs = []
    offsets = [(-2.0, -1.5), (1.8, 1.2), (0.2, 2.2), (-1.4, 1.9)]  # arcsec
    for i, (de, dn) in enumerate(offsets):
        srcs.append(star_source(
            u=(30.0 + de / 3600 / np.cos(np.deg2rad(10.0)), 10.0 + dn / 3600),
            flux_r=20.0 + 8.0 * i))
    return make_synthetic_stamp(srcs, shape=(31, 31), bands=(2,), seed=21)


def _joint_vec(scene_data):
    parts = [np.concatenate([scene_data.wcs.equa2duas(s["u"]), np.log(s["flux"])])
             for s in scene_data.sources]
    return np.concatenate(parts).astype(np.float32)


def _gibbs_start(scene_data, kinds, vec, n_chains):
    """JAX's Gibbs state at ``vec`` carried into the port, then spread to
    ``n_chains`` chains; the port's posterior and its scene."""
    j_logd = j_crowded(JScene(kinds=kinds, n_bands=5), [scene_data.stamps[0]], bands=[2])
    jstate = j_gibbs_init(jnp.asarray(vec), j_logd)
    one = gibbs_state_from_numpy(np.asarray(jstate.x), np.asarray(jstate.logp))
    scene = CrowdedScene(kinds=kinds, n_bands=5)
    logd = make_crowded_logdensity(scene, [port_stamp(scene_data.stamps[0])], bands=[2])
    np.testing.assert_allclose(logd(one.x).numpy(), one.logp.numpy(), rtol=2e-6, atol=1.0)
    return scene, logd, type(one)(x=one.x.expand(n_chains, -1).clone(),
                                  logp=one.logp.expand(n_chains).clone())


def _run(kern, state, n, seed):
    gen = seeded_generator("cpu", seed)
    accepted, xs = [], []
    with torch.no_grad():
        for _ in range(n):
            state, info = kern(gen, state)
            accepted.append(info.accepted)
            xs.append(state.x)
    return state, torch.stack(accepted, 1), torch.stack(xs, 1)


def test_color_sources_equal_jax():
    rng = np.random.default_rng(4)
    for n, radius in ((12, 3.0), (40, 1.5)):
        pos = rng.uniform(-6.0, 6.0, (n, 2))
        assert np.array_equal(color_sources(pos, radius), j_color_sources(pos, radius))


def test_gibbs_sweep_moves_all_blocks(crowded_scene):
    kinds = ("star",) * 4
    scene, logd, state = _gibbs_start(crowded_scene, kinds, _joint_vec(crowded_scene), 4)
    blocks = [(off, d) for off, d, _ in scene.block_slices()[0]]
    kern = block_gibbs_kernel(logd, blocks, torch.full((scene.dim,), 0.01))
    state2, acc, _ = _run(kern, state, 100, seed=0)
    assert acc.shape == (4, 100, 4)
    rate = acc.to(torch.float64).mean(dim=(0, 1)).numpy()
    assert np.all(rate > 0.05), rate  # every source block mixes
    assert bool(torch.all(state2.logp >= state.logp - 50.0))
    np.testing.assert_allclose(logd(state2.x).numpy(), state2.logp.numpy(), rtol=2e-6, atol=1.0)


def test_colored_gibbs(crowded_scene):
    kinds = ("star",) * 4
    scene, logd, state = _gibbs_start(crowded_scene, kinds, _joint_vec(crowded_scene), 4)
    pos = np.stack([crowded_scene.wcs.equa2duas(s["u"]) for s in crowded_scene.sources])
    colors = color_sources(pos, radius=3.0)
    assert colors.max() >= 1  # overlapping sources got split into classes
    blocks = [(off, d) for off, d, _ in scene.block_slices()[0]]
    kern = colored_gibbs_kernel(logd, blocks, colors, torch.full((scene.dim,), 0.01))
    _, acc, _ = _run(kern, state, 60, seed=3)
    assert acc.shape == (4, 60, int(colors.max()) + 1)
    assert float(acc.to(torch.float64).mean()) > 0.05


def test_mixed_kind_gibbs_moves_every_coordinate():
    """Mixed star/galaxy block widths leave no coordinate frozen."""
    cosd = np.cos(np.deg2rad(10.0))
    srcs2 = [galaxy_source(u=(30.0 - 3 / 3600 / cosd, 10.0), flux_r=60.0),
             star_source(u=(30.0 + 3 / 3600 / cosd, 10.0), flux_r=30.0)]
    sd = make_synthetic_stamp(srcs2, shape=(25, 25), bands=(2,), seed=71)
    v0 = np.zeros(18, np.float32)
    v0[:2] = sd.wcs.equa2duas(srcs2[0]["u"])
    v0[2:7] = np.log(srcs2[0]["flux"])
    v0[7:11] = [0, 0.3, 0, 0.5]
    v0[11:13] = sd.wcs.equa2duas(srcs2[1]["u"])
    v0[13:18] = np.log(srcs2[1]["flux"])
    scene, logd, state = _gibbs_start(sd, ("galaxy", "star"), v0, 2)
    blocks = [(off, d) for off, d, _ in scene.block_slices()[0]]
    kern = block_gibbs_kernel(logd, blocks, torch.full((scene.dim,), 0.01))
    _, _, xs = _run(kern, state, 80, seed=0)
    moved = (xs.std(dim=1) > 0).all(dim=0).numpy()
    assert moved.all(), np.where(~moved)[0]


def _gauss_logd(x):
    d = x - torch.as_tensor(MEAN, dtype=torch.float32)
    return -0.5 * torch.einsum("bi,ij,bj->b", d, torch.as_tensor(PREC, dtype=torch.float32), d)


def _jax_walkers(seed, n):
    """JAX's initial ensemble, as tests/test_stretch_and_artifacts.py draws
    it, carried into the port with its log densities."""
    k_i, _ = jax.random.split(jax.random.key(seed))
    xs0 = jnp.asarray(MEAN, jnp.float32) + jax.random.normal(k_i, (n, 2))
    prec = jnp.asarray(PREC, jnp.float32)
    js = j_stretch_init(xs0, lambda x: -0.5 * (x - MEAN) @ prec @ (x - MEAN))
    state = stretch_state_from_numpy(np.asarray(js.xs), np.asarray(js.logps))
    np.testing.assert_allclose(_gauss_logd(state.xs).numpy(), state.logps.numpy(), rtol=1e-5,
                               atol=1e-5)
    return state


def _stretch_run(logd, state, n, seed):
    kern = stretch_kernel(logd)
    gen = seeded_generator("cpu", seed)
    xs, acc = [], []
    for _ in range(n):
        state, info = kern(gen, state)
        xs.append(state.xs)
        acc.append(float(info.accept_rate))
    return torch.stack(xs), np.asarray(acc)


def test_stretch_gaussian():
    state = _jax_walkers(0, 64)
    xs, acc = _stretch_run(_gauss_logd, state, 800, seed=1)
    assert 0.2 < acc.mean() < 0.8, acc.mean()
    kept = xs[200:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(kept.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(kept.T), COV, atol=0.5)


def test_stretch_affine_invariance():
    """Acceptance statistics are unchanged under an affine
    reparameterization of the target (and the same walkers mapped)."""
    a_mat = torch.tensor([[30.0, 0.0], [5.0, 0.02]])

    def logd_skewed(y):
        return _gauss_logd(torch.linalg.solve(a_mat, y.T).T)

    state = _jax_walkers(1, 64)
    ys = state.xs @ a_mat.T
    _, a1 = _stretch_run(_gauss_logd, state, 300, seed=2)
    _, a2 = _stretch_run(logd_skewed, stretch_init(ys, logd_skewed), 300, seed=2)
    assert abs(a1[100:].mean() - a2[100:].mean()) < 0.05, (a1[100:].mean(), a2[100:].mean())
