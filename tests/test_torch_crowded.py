"""The port's crowded-field posterior (``celeste_tpu_torch.parallel.crowded``,
``bench/config5.py``) on the CPU against the JAX package, at BASELINE
config 5 (12 sources, 48x128 r band).

States: the first 8 chains of the JAX package's warm-start artifact
(``celeste_tpu/bench/artifacts/config5_prep.npz``, read through the port's
loader), and 8 probes drawn with numpy around the truth.  Log-densities
rtol 2e-6, atol 1.0; gradients rtol 5e-4, atol 0.1 (the tiled kernel gates,
tests/test_tiled_field.py:97, :129).  The artifact's saved ``logp`` is
stale against today's code (off by ~5 nats), so it is compared with
nothing; the artifact serves only as a source of realistic states.  The
parity gate: the tiled-vs-dense gap under 1.0 nats, and a 0.05 radii cut
trips it above 100 (tests/test_tiled_field.py:359-384).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.bench.config5 import build_config5 as j_build_config5
from celeste_tpu.inference import whiten_logdensity as j_whiten
from celeste_tpu.parallel import CrowdedScene as JScene

from celeste_tpu_torch.bench.config5 import build_config5, config5_parity_gap
from celeste_tpu_torch.experiments import CONFIGS, run_experiment
from celeste_tpu_torch.inference import whiten_logdensity
from celeste_tpu_torch.interop import load_config5_prep
from celeste_tpu_torch.parallel import CrowdedScene
from celeste_tpu_torch.parallel.crowded import make_tiled_crowded_logdensity

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(ROOT, "celeste_tpu", "bench", "artifacts", "config5_prep.npz")
TOL = dict(rtol=2e-6, atol=1.0)
GRAD_TOL = dict(rtol=5e-4, atol=0.1)


@pytest.fixture(scope="module")
def config5():
    j_tiled, j_dense, jvec, _ = j_build_config5()
    t_tiled, t_dense, tvec, tinfo = build_config5(device="cpu")
    prep = load_config5_prep(PREP)
    probes = (np.asarray(jvec)[None] + 0.01 * np.random.default_rng(21).normal(size=(8, 44)))
    states = np.concatenate([prep["states_x"].x[:8].numpy(), probes.astype(np.float32)])
    return {"j_tiled": j_tiled, "j_dense": j_dense, "t_tiled": t_tiled, "t_dense": t_dense,
            "jvec": jvec, "tvec": tvec, "tinfo": tinfo, "prep": prep, "states": states}


@pytest.fixture(scope="module")
def jax_values(config5):
    """JAX value and gradient of both log-densities at the 16 states (one
    compile each)."""
    x = jnp.asarray(config5["states"])
    vt, gt = jax.jit(jax.vmap(jax.value_and_grad(config5["j_tiled"])))(x)
    vd, gd = jax.jit(jax.vmap(jax.value_and_grad(config5["j_dense"])))(x)
    return {"tiled": (np.asarray(vt), np.asarray(gt)), "dense": (np.asarray(vd), np.asarray(gd))}


def test_crowded_scene_layout():
    kinds = ("star", "galaxy", "star")
    for nb in (1, 5):
        j, t = JScene(kinds=kinds, n_bands=nb), CrowdedScene(kinds=kinds, n_bands=nb)
        assert t.block_slices() == j.block_slices()
        assert t.dim == j.dim == 2 * (2 + nb) + 6 + nb
        assert t.n_sources == 3
        vec = np.random.default_rng(nb).normal(size=t.dim).astype(np.float32)
        for tp, jp in zip(t.unpack(torch.as_tensor(vec)), j.unpack(jnp.asarray(vec))):
            assert type(tp).__name__ == type(jp).__name__
            for name in ("u", "flux"):
                np.testing.assert_allclose(getattr(tp, name).numpy(),
                                           np.asarray(getattr(jp, name)), rtol=1e-6)


@pytest.mark.parametrize("which", ["tiled", "dense"])
@pytest.mark.parametrize("states", ["artifact", "probes"])
def test_config5_logdensity_matches_jax(config5, jax_values, which, states):
    rows = slice(0, 8) if states == "artifact" else slice(8, 16)
    x = torch.as_tensor(config5["states"][rows]).requires_grad_(True)
    logd = config5["t_" + which]
    v = logd(x)
    (g,) = torch.autograd.grad(v.sum(), x)
    want_v, want_g = (a[rows] for a in jax_values[which])
    np.testing.assert_allclose(v.detach().numpy(), want_v, **TOL)
    np.testing.assert_allclose(g.numpy(), want_g, **GRAD_TOL)


def test_whitened_logdensity_matches_jax_on_artifact(config5):
    """z-space log density of the artifact's moments at its z-space states,
    and the maps between the spaces, against the JAX package."""
    prep = config5["prep"]
    m, cov = prep["m_hat"].numpy(), prep["cov_hat"].numpy()
    j_logd_z, j_to_x, j_to_z = j_whiten(config5["j_tiled"], m, cov)
    logd_z, to_x, to_z = whiten_logdensity(config5["t_tiled"], prep["m_hat"], prep["cov_hat"])
    z = prep["states_z"].x[:8]
    x = to_x(z)
    np.testing.assert_allclose(x.numpy(), np.asarray(j_to_x(jnp.asarray(z.numpy()))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(to_z(x).numpy(), np.asarray(j_to_z(jnp.asarray(x.numpy()))),
                               rtol=1e-4, atol=1e-4)
    # |x| ~ 9 against posterior stds ~ 6e-3: float32 x resolves z to ~1e-4
    torch.testing.assert_close(to_z(x), z, rtol=0, atol=2e-4)
    with torch.no_grad():
        got = logd_z(z).numpy()
    want = np.asarray(jax.jit(jax.vmap(j_logd_z))(jnp.asarray(z.numpy())))
    np.testing.assert_allclose(got, want, **TOL)


def test_parity_gap_and_radii_cut(config5):
    gap, rel = config5_parity_gap(config5["t_tiled"], config5["t_dense"], config5["tvec"])
    assert gap < 1.0, (gap, rel)
    cut, _, _, _ = build_config5(radii_scale=0.05, device="cpu")
    gap_cut, _ = config5_parity_gap(cut, config5["t_dense"], config5["tvec"])
    assert gap_cut > 100.0 and gap_cut > 100 * gap, (gap_cut, gap)
    big, _, _, _ = build_config5(radii_scale=1.5, device="cpu")
    assert config5_parity_gap(big, config5["t_dense"], config5["tvec"])[0] < 1.0


def test_log_density_at_truth(config5):
    """Tiled and dense agree at the truth, and every chain of a batch is
    evaluated on its own (a batch equals its rows)."""
    x = config5["tvec"][None]
    with torch.no_grad():
        lt, ld = config5["t_tiled"](x), config5["t_dense"](x)
        rows = torch.as_tensor(config5["states"][:3])
        batch = config5["t_tiled"](rows)
        single = torch.cat([config5["t_tiled"](rows[i:i + 1]) for i in range(3)])
    assert abs(float(lt[0] - ld[0])) < 1.0
    torch.testing.assert_close(batch, single, rtol=1e-6, atol=1e-2)


def test_multiband_tiled_is_not_yet_ported(config5):
    info = config5["tinfo"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_tiled_crowded_logdensity(info["scene"], [info["stamp"]] * 2, [0, 1],
                                      positions_px=info["positions_px"])


def test_run_experiment_crowded_field_tiled():
    """``crowded_field`` with ``tiled=true n_galaxies=2`` through the entry
    point, at a few chains and steps, with its default sampler (ChEES in
    the whitened space of the pooled dense metric)."""
    cfg = copy.deepcopy(CONFIGS["crowded_field"])
    assert (cfg.sampler, cfg.metric, cfg.n_chains, cfg.shape, cfg.n_sources) == \
        ("chees", "dense", 256, (41, 41), 10)
    for k, v in dict(device="cpu", tiled=True, n_galaxies=2, n_sources=3, shape=(16, 16),
                     n_chains=4, n_warmup=8, n_steps=6, n_leapfrog=1, max_depth=2).items():
        setattr(cfg, k, v)
    res = run_experiment(cfg)
    d = 2 * 7 + 3
    assert res["samples"].shape == (4, 6, d)
    assert np.all(np.isfinite(res["samples"]))
    assert res["step_size"] > 0 and res["trajectory_length"] >= res["step_size"]
    assert 0.0 <= res["accept_rate"] <= 1.0 and res["divergence_rate"] <= 0.5
    # NUTS with the diagonal metric, on the dense likelihood
    cfg.sampler, cfg.metric, cfg.tiled, cfg.n_steps = "nuts", "diag", False, 8
    res = run_experiment(cfg)
    assert res["samples"].shape == (4, 8, d) and np.all(np.isfinite(res["samples"]))


def test_package_imports_no_jax():
    """Every module of the port imports with JAX made unimportable."""
    code = ("import sys, pkgutil, importlib\n"
            "sys.modules['jax'] = None\n"
            "import celeste_tpu_torch\n"
            "for m in pkgutil.walk_packages(celeste_tpu_torch.__path__, 'celeste_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_build_config5_runs_on_the_card_unless_asked(monkeypatch):
    """The config-5 entry point defaults to the card and raises, with no
    CPU fallback, where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        build_config5()
