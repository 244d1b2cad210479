"""The port's last public functions against the JAX package's, on the CPU:
``mog.mog``, ``mog.logpdf_grid``, ``likelihood.poisson.multi_stamp_loglik``,
``model.params.sigmoid``, ``utils.metrics.get_logger`` and ``device_log``,
``inference.runner.run_chains``, ``parallel.mesh.replicated``; and the
check that every public top-level name of ``celeste_tpu`` has a
counterpart in ``celeste_tpu_torch`` (an ``ast`` walk over both packages),
but for what the port leaves behind by design (ROADMAP.md).

Tolerances: elementwise float32 algebra in the same order agrees to rtol
1e-6 (the port's model tests); a log-likelihood summed over two bands of
~625 pixels of magnitude ~1e3 to rtol 2e-6, atol 0.5 (K1's gate).
"""

import ast
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu import mog as jmog
from celeste_tpu.data.synthetic import make_synthetic_stamp as j_make, star_source
from celeste_tpu.inference.runner import run_chains as j_run_chains
from celeste_tpu.likelihood import multi_stamp_loglik as j_multi_stamp_loglik
from celeste_tpu.model.params import StarParams as JStar, sigmoid as j_sigmoid
from celeste_tpu.model.stamp import stack_stamps as j_stack_stamps
from celeste_tpu.parallel.mesh import make_mesh as j_make_mesh, replicated as j_replicated
from celeste_tpu.utils import metrics as jm

from celeste_tpu_torch import mog as tmog
from celeste_tpu_torch.inference.hmc import HMCInfo, HMCState
from celeste_tpu_torch.inference.runner import run_chains
from celeste_tpu_torch.likelihood import multi_stamp_loglik
from celeste_tpu_torch.model.params import sigmoid
from celeste_tpu_torch.model.stamp import stack_stamps
from celeste_tpu_torch.parallel.mesh import replicated
from celeste_tpu_torch.utils import metrics as tm

from torch_port_helpers import one_torch_thread, port_params, port_stamp  # noqa: F401 (autouse fixture)

EXACT = dict(rtol=1e-6, atol=1e-6)
ROOT = Path(__file__).resolve().parent.parent
# public names the port leaves behind by design (ROADMAP.md, "What the port
# leaves behind"): the custom_vmap plumbing for vmapped per-chain samplers
LEFT_BEHIND = {"inference/vg.py"}


def _random_mog(rng, k):
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    mu = rng.normal(size=(k, 2)).astype(np.float32)
    a = rng.normal(size=(k, 2, 2))
    cov = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(2)).astype(np.float32)
    return w, mu, cov


def test_mog_constructor_matches_jax():
    w, mu, cov = _random_mog(np.random.default_rng(0), 5)
    got, want = tmog.mog(w, mu, cov), jmog.mog(w, mu, cov)
    for name in ("w", "mu", "cov"):
        t, j = getattr(got, name), getattr(want, name)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("k", [1, 4])
def test_logpdf_grid_matches_jax(k):
    """logsumexp over components, on a grid reaching far into the tails."""
    rng = np.random.default_rng(k)
    w, mu, cov = _random_mog(rng, k)
    px = rng.uniform(-12.0, 12.0, (7, 9)).astype(np.float32)
    py = rng.uniform(-12.0, 12.0, (7, 9)).astype(np.float32)
    got = tmog.logpdf_grid(tmog.mog(w, mu, cov), torch.as_tensor(px), torch.as_tensor(py))
    want = jmog.logpdf_grid(jmog.mog(w, mu, cov), jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    dens = tmog.eval_grid(tmog.mog(w, mu, cov), torch.as_tensor(px), torch.as_tensor(py))
    near = dens.numpy() > 1e-20
    np.testing.assert_allclose(np.exp(got.numpy())[near], dens.numpy()[near], rtol=1e-5)


def test_sigmoid_matches_jax():
    x = np.random.default_rng(1).normal(scale=8.0, size=64).astype(np.float32)
    np.testing.assert_allclose(sigmoid(torch.as_tensor(x)).numpy(), np.asarray(j_sigmoid(x)),
                               **EXACT)


def test_multi_stamp_loglik_matches_jax():
    """Two bands (g, r) of one star's scene, stacked with a leading band
    axis in each package; the sum of the per-band log-likelihoods."""
    src = star_source(u=(30.0001, 9.9999), flux_r=25.0)
    scene = j_make([src], shape=(25, 25), bands=(1, 2), seed=3)
    jparams = [JStar(u=jnp.asarray(scene.wcs.equa2duas(src["u"]), jnp.float32),
                     flux=jnp.asarray(src["flux"], jnp.float32))]
    tparams = [port_params(src, scene.wcs, "star")]
    for normalized, centered in ((False, False), (True, False), (False, True)):
        want = float(j_multi_stamp_loglik(jparams, j_stack_stamps(scene.stamps),
                                          normalized=normalized, centered=centered))
        got = float(multi_stamp_loglik(tparams, stack_stamps([port_stamp(s)
                                                              for s in scene.stamps]),
                                       normalized=normalized, centered=centered))
        assert abs(got - want) <= 0.5 + 2e-6 * abs(want), (normalized, centered, got, want)


def test_get_logger_and_device_log_match_jax(monkeypatch):
    """``device_log`` writes through the default logger that ``get_logger``
    makes once; the record's fields equal the JAX package's for the same
    values."""
    monkeypatch.setattr(tm, "_DEFAULT_LOGGER", None)
    assert tm.get_logger() is tm.get_logger()
    bufs = {"port": io.StringIO(), "jax": io.StringIO()}
    monkeypatch.setattr(tm, "_DEFAULT_LOGGER", tm.MetricsLogger(stream=bufs["port"]))
    monkeypatch.setattr(jm, "_DEFAULT_LOGGER", jm.MetricsLogger(stream=bufs["jax"]))
    x = np.random.default_rng(2).normal(size=(3,)).astype(np.float32)
    tm.device_log("window", mean=torch.as_tensor(x).mean(), xs=torch.as_tensor(x), step=7)

    @jax.jit
    def f(v):
        jm.device_log("window", mean=jnp.mean(v), xs=v, step=jnp.int32(7))
        return v

    f(jnp.asarray(x)).block_until_ready()
    jax.effects_barrier()
    got, want = (json.loads(b.getvalue()) for b in (bufs["port"], bufs["jax"]))
    assert got.pop("t") >= 0 and want.pop("t") >= 0
    assert got.keys() == want.keys() and got["event"] == want["event"] == "window"
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)
    np.testing.assert_allclose(got["xs"], want["xs"], rtol=1e-6)
    assert got["step"] == want["step"] == 7


@pytest.mark.parametrize("thin", [1, 3])
def test_run_chains_matches_jax(thin):
    """One chain through a deterministic kernel (a contraction toward a
    point, with its info), so the two packages' random streams play no
    part: the kept positions, the final state and the infos, at any
    ``thin``, with a custom ``collect``."""
    target = np.array([1.0, -2.0, 0.5], np.float32)
    x0 = np.array([4.0, 3.0, -1.0], np.float32)

    def t_kernel(gen, s):
        x = 0.7 * s.x + 0.3 * torch.as_tensor(target)
        logp = -0.5 * (x ** 2).sum(-1)
        return (HMCState(x, logp, -x),
                HMCInfo(torch.ones_like(logp, dtype=torch.bool), 0.9 * torch.ones_like(logp),
                        logp, torch.zeros_like(logp)))

    def j_kernel(key, s):
        x = 0.7 * s.x + 0.3 * jnp.asarray(target)
        logp = -0.5 * jnp.sum(x ** 2, -1)
        return (HMCState(x, logp, -x),
                HMCInfo(jnp.ones_like(logp, dtype=bool), 0.9 * jnp.ones_like(logp), logp,
                        jnp.zeros_like(logp)))

    xt = torch.as_tensor(x0)
    t_state = HMCState(xt, -0.5 * (xt ** 2).sum(), -xt)
    xj = jnp.asarray(x0)
    j_state = HMCState(xj, -0.5 * jnp.sum(xj ** 2), -xj)
    def collect(s, i):
        return s.x * i.accept_prob

    got = run_chains(torch.Generator().manual_seed(0), t_kernel, t_state, 12, thin, collect)
    want = jax.jit(lambda k, s: j_run_chains(k, j_kernel, s, 12, thin, collect))(
        jax.random.key(0), j_state)
    assert got[0].shape == (12 // thin, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **EXACT)
    for t, j in zip(got[1], want[1]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT)
    for t, j in zip(got[2], want[2]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT)


def test_replicated_matches_jax():
    """Every rank holds a replicated axis whole: the port's rows are the
    JAX sharding's shard shape, on no mesh (one process) as on JAX's."""
    x = torch.arange(24.0).reshape(8, 3)
    sharding = j_replicated(j_make_mesh())
    assert tuple(x[replicated(None)].shape) == sharding.shard_shape(tuple(x.shape))
    assert torch.equal(x[replicated(None)], x)


def _public_names(root: Path) -> dict:
    """{module path: public top-level names}: functions and classes defined
    there, and names imported into it (a re-export is a counterpart)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        if "_build" in path.relative_to(root).parts:    # build outputs, not the package
            continue
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.ImportFrom):
                names.update(a.asname or a.name for a in node.names)
        out[str(path.relative_to(root))] = {n for n in names if not n.startswith("_")}
    return out


def test_every_public_name_has_a_counterpart():
    """The ``ast`` comparison: each public top-level function or class of a
    ``celeste_tpu`` module exists in the ``celeste_tpu_torch`` module of the
    same path, but for the modules the port leaves behind."""
    jax_names = _public_names(ROOT / "celeste_tpu")
    port_names = _public_names(ROOT / "celeste_tpu_torch")
    missing = {}
    for module, names in jax_names.items():
        if module in LEFT_BEHIND:
            continue
        defined = {n for n in names if n not in _imported(ROOT / "celeste_tpu" / module)}
        gap = defined - port_names.get(module, set())
        if gap:
            missing[module] = sorted(gap)
    assert not missing, missing


def _imported(path: Path) -> set:
    """Names a module imports (not its own definitions)."""
    return {a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names}
