"""The port's source- and chain-sharded crowded field
(``celeste_tpu_torch.parallel``: mesh, collectives, ensemble, the sharded
log-likelihoods) and the tiled render's plain versions, on the CPU, against
the JAX package.

The sharded code runs on gloo ranks spawned by the port's launcher, one
world per mesh shape: {chains 2, sources 2} and {chains 1, sources 4}.  The
ranks import only the port and NumPy (``torch_sharded_workers.py``); the
JAX references come from this process, on the virtual CPU mesh of the same
shape, and states go both ways as NumPy arrays.

Tolerances: planes rtol 1e-5, atol 1e-5 (the stamp planes' gate); the
sharded tiled log-likelihood rtol 1e-5, atol 1.0, the dense one atol 0.5
(tests/test_parallel.py:260, :323, :348); the plain render against the
Pallas pair in interpret mode rtol 1e-5, atol 1e-4 for lambda and rtol
2e-4, atol 5e-3 for cotangents (tests/test_tiled_field.py:318-356);
sharded gradients against the single-process gradient rtol 5e-4, atol 0.1
(the tiled gradient gate), a check that fails if the source shards'
gradients were summed once too often.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data import synthetic as jsynth
from celeste_tpu.kernels import mog_field as jmf
from celeste_tpu.kernels import tiled_field as jtf
from celeste_tpu.parallel import CrowdedScene as JScene
from celeste_tpu.parallel import make_mesh as j_make_mesh
from celeste_tpu.parallel.crowded import (
    crowded_rect_logprior as j_rect_logprior,
    sharded_crowded_loglik as j_sharded_dense,
    sharded_tiled_crowded_loglik as j_sharded_tiled,
)

from celeste_tpu_torch.kernels import mog_field as tmf
from celeste_tpu_torch.kernels import tiled_field as ttf
from celeste_tpu_torch.kernels.tiled_field import random_tile_problem
from celeste_tpu_torch.multichip import dryrun_multichip
from celeste_tpu_torch.parallel import (
    CrowdedScene,
    build_tile_map,
    crowded_rect_logprior,
    launch,
    make_tiled_crowded_logdensity,
    sharded_tiled_crowded_loglik,
)

import torch_sharded_workers as w
from torch_port_helpers import one_torch_thread, port_stamp  # noqa: F401 (autouse fixture)

PLANE_TOL = dict(rtol=1e-5, atol=1e-5)
TILED_TOL = dict(rtol=1e-5, atol=1.0)
DENSE_TOL = dict(rtol=1e-5, atol=0.5)
GRAD_TOL = dict(rtol=5e-4, atol=0.1)
NAMES = ("amp", "mx", "my", "pa", "pb", "pc")
MESHES = {"2x2": {"chains": 2, "sources": 2}, "1x4": {"chains": 1, "sources": 4}}
N_STATES = 8
HOSTILE = [35.0, -40.0, 28.0, -33.0]     # star padding (tests/test_parallel.py:362)
SEED, N_MH, N_CHEES = 3, 50, 12


@pytest.fixture(scope="module")
def problems():
    """Both scenes in both packages: JAX stamp and scene, positions, and
    N_STATES rectangular states near the truth (NumPy float32)."""
    out = {}
    for i, name in enumerate(w.SCENES):
        spec = w.SCENES[name]
        sd = jsynth.make_synthetic_stamp(w.make_sources(jsynth, name), shape=spec["shape"],
                                         bands=(2,), seed=spec["seed"])
        jstamp = sd.stamps[0]
        pos = np.stack([np.asarray(jstamp.duas2pixel(jnp.asarray(sd.wcs.equa2duas(s["u"]),
                                                                  jnp.float32)))
                        for s in sd.sources])
        truth = w.truth_rect(sd, spec["kinds"])
        rng = np.random.default_rng(10 + i)
        vecs = (truth[None] + 0.02 * rng.normal(size=(N_STATES,) + truth.shape))
        out[name] = {"jstamp": jstamp, "tstamp": port_stamp(jstamp), "pos": pos,
                     "jscene": JScene(kinds=spec["kinds"], n_bands=w.N_BANDS),
                     "vecs": vecs.astype(np.float32), "radius": spec["radius"]}
    return out


def _scene(p):
    """The port's CrowdedScene of a problem."""
    return CrowdedScene(kinds=p["jscene"].kinds, n_bands=w.N_BANDS)


def _ensemble_start():
    return np.random.default_rng(4).normal(size=(16, w.GAUSS_D)).astype(np.float32)


def _bucket_vecs():
    sd = jsynth.make_synthetic_stamp(w.bucket_field_sources(jsynth),
                                     shape=w.BUCKET_FIELD["shape"], bands=(2,),
                                     seed=w.BUCKET_FIELD["seed"])
    rows = np.stack([np.concatenate([sd.wcs.equa2duas(s["u"]), np.log(s["flux"])])
                     for s in sd.sources])
    return np.tile(rows[None], (4, 1, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def worlds(problems):
    """Each mesh shape's world, spawned once: every rank's results."""
    jobs = {name: (w.sharded_values_and_grads, dict(name=name, vecs=p["vecs"]))
            for name, p in problems.items()}
    out = {}
    for shape, extra in (("2x2", {"ensemble": (w.ensemble_runs, dict(
                             x0=_ensemble_start(), seed=SEED, n_mh=N_MH, n_warmup=N_CHEES))}),
                         ("1x4", {"collectives": (w.collective_values, dict(axis="sources")),
                                  "buckets": (w.bucketed_values, dict(vecs=_bucket_vecs()))})):
        out[shape] = launch(w.world_checks, 4, MESHES[shape], dict(jobs, **extra))
    return out


def _by_chains(results, key, field):
    """The ranks' per-chain results in chain order; the ranks of a sources
    group must agree bitwise."""
    blocks = {}
    for r in results:
        c = r["coords"]["chains"]
        val = r[key][field]
        if c in blocks:
            np.testing.assert_array_equal(val, blocks[c])
        blocks[c] = val
    return np.concatenate([blocks[c] for c in sorted(blocks)])


# ---------------------------------------------------------------------------
# single-process pieces against JAX
# ---------------------------------------------------------------------------

def test_mixed_field_planes_match_jax(problems):
    p = problems["mixed"]
    rect = p["vecs"].copy()
    rect[:4, 1, 7:] = HOSTILE                       # star rows: hostile padding
    rect[:4, 3, 7:] = HOSTILE
    flags = p["jscene"].is_star_flags
    flat = rect.reshape(-1, rect.shape[-1])
    flag_rows = np.tile(flags, N_STATES)
    weights = np.random.default_rng(0).normal(size=(6, flat.shape[0], 16 * 3)).astype(np.float32)

    def j_total(v):
        planes = jax.vmap(lambda x, f: jmf.mixed_field_planes(x, p["jstamp"], 2, 5, f))(
            v, jnp.asarray(flag_rows))
        return sum(jnp.sum(pl * wt) for pl, wt in zip(planes, weights)), planes

    (_, want), want_g = jax.jit(jax.value_and_grad(j_total, has_aux=True))(jnp.asarray(flat))
    x = torch.as_tensor(flat).requires_grad_(True)
    got = tmf.mixed_field_planes(x, p["tstamp"], 2, 5, torch.as_tensor(flag_rows))
    total = sum(torch.sum(pl * torch.as_tensor(wt)) for pl, wt in zip(got, weights))
    (g,) = torch.autograd.grad(total, x)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape == (flat.shape[0], 16 * 3)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **PLANE_TOL)
    assert np.all(np.isfinite(g.numpy()))
    # the gradient of the weighted sum adds 6 x 48 plane terms per coordinate
    # in another order than JAX: 1e-4 (measured 5.3e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)
    # a star's padding never reaches its planes; its blocks past the first are zero
    star_rows = np.where(flag_rows)[0]
    assert np.all(g.numpy()[star_rows, 7:] == 0.0)
    assert all(bool((pl.detach()[star_rows, 3:] == 0).all()) for pl in got)


def test_rect_layout_and_prior_match_jax(problems):
    p = problems["mixed"]
    js, cs = p["jscene"], _scene(p)
    packed = js.from_rect(jnp.asarray(p["vecs"]))
    np.testing.assert_array_equal(cs.from_rect(p["vecs"]), np.asarray(packed))
    np.testing.assert_array_equal(cs.from_rect(torch.as_tensor(p["vecs"])).numpy(),
                                  np.asarray(packed))
    np.testing.assert_array_equal(cs.to_rect(np.array(packed)), np.asarray(js.to_rect(packed)))
    np.testing.assert_array_equal(cs.to_rect(torch.as_tensor(np.array(packed))).numpy(),
                                  np.asarray(js.to_rect(packed)))
    assert cs.rect_dim == js.rect_dim == 11
    np.testing.assert_array_equal(cs.is_star_flags, js.is_star_flags)
    rect = p["vecs"].copy()
    rect[:, 1, 7:] = 0.5                            # the anchor term counts
    want = np.asarray(jax.vmap(lambda v: j_rect_logprior(js, v))(jnp.asarray(rect)))
    got = crowded_rect_logprior(cs, torch.as_tensor(rect)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


def test_plain_render_pair_matches_jax_pallas_interpret():
    """Plain K5 against the JAX render in interpret mode, plain K6 against
    ``_tiled_render_bwd_pallas`` in interpret mode, called directly."""
    planes, tile_src, pixels, _ = random_tile_problem(seed=8, b=5, s=4, t=3)
    px, py = pixels[:2]
    g = np.random.default_rng(9).normal(size=(3, 5, 1024)).astype(np.float32)
    jp = tuple(jnp.asarray(x) for x in planes)
    want = jtf.tiled_field_render_explicit(jp, jnp.asarray(tile_src), jnp.asarray(px),
                                           jnp.asarray(py), n_comp=3, s_max=4, interpret=True)
    want_d = jtf._tiled_render_bwd_pallas(jp, jnp.asarray(tile_src), jnp.asarray(px),
                                          jnp.asarray(py), jnp.asarray(g), 3, 4, 128, True)
    tp = tuple(torch.as_tensor(x) for x in planes)
    ts, tpx, tpy = (torch.as_tensor(x) for x in (tile_src, px, py))
    got = ttf._tiled_render_torch(tp, ts, tpx, tpy, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    got_d = ttf._tiled_render_bwd_torch(tp, ts, tpx, tpy, torch.as_tensor(g), 3)
    for name, a, b in zip(NAMES, got_d, want_d):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=5e-3, err_msg=name)
    # the plain backward is the plain forward's autograd
    leaves = [x.clone().requires_grad_(True) for x in tp]
    auto = torch.autograd.grad(ttf._tiled_render_torch(leaves, ts, tpx, tpy, 3), leaves,
                               torch.as_tensor(g))
    for name, a, b in zip(NAMES, got_d, auto):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=5e-3, msg=name)


def test_render_entry_points_on_cpu_tensors(problems):
    """CPU tensors take the plain pair through the autograd function and
    launch nothing; the kernels' wrappers refuse CPU tensors; a table of
    sentinels renders exactly 0 with finite cotangents."""
    planes, tile_src, pixels, _ = random_tile_problem(seed=3, b=4)
    tp = [torch.as_tensor(x).requires_grad_(True) for x in planes]
    ts, px, py = torch.as_tensor(tile_src), torch.as_tensor(pixels[0]), torch.as_tensor(pixels[1])
    before = ttf.launch_counts()
    lam = ttf.tiled_field_render_explicit(tp, ts, px, py, n_comp=3, s_max=4)
    g = torch.as_tensor(np.random.default_rng(2).normal(size=lam.shape).astype(np.float32))
    grads = torch.autograd.grad(lam, tp, g)
    assert ttf.launch_counts() == before
    torch.testing.assert_close(lam, ttf._tiled_render_torch(tp, ts, px, py, 3), rtol=0, atol=0)
    for a, b in zip(grads, ttf._tiled_render_bwd_torch([x.detach() for x in tp], ts, px, py,
                                                       g, 3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="s_max"):
        ttf.tiled_field_render_explicit(tp, ts, px, py, n_comp=3, s_max=5)
    # over a TiledStampData's whole table, as the explicit call with its table
    p = problems["stars"]
    cs = _scene(p)
    data = ttf.TiledStampData(build_tile_map(p["pos"], p["radius"], tuple(p["tstamp"].counts.shape)),
                              p["tstamp"])
    planes_s = ttf.scene_planes_padded(cs, torch.as_tensor(cs.from_rect(p["vecs"])), p["tstamp"], 2)
    torch.testing.assert_close(
        ttf.tiled_field_render(planes_s, data, n_comp=3),
        ttf.tiled_field_render_explicit(planes_s, data.tile_src, *data.pixels[:2], n_comp=3,
                                        s_max=data.tile_map.s_max), rtol=0, atol=0)
    detached = [x.detach() for x in tp]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttf.tiled_render_cuda(*detached, ts, px, py, n_comp=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttf.tiled_render_bwd_cuda(*detached, ts, px, py, g,
                                  *(torch.as_tensor(c) for c in ttf.tile_columns(tile_src, 3, 15)),
                                  n_comp=3)
    only_sentinel = torch.full((3, 4), 4, dtype=torch.int32)
    assert bool((ttf._tiled_render_torch(detached, only_sentinel, px, py, 3) == 0).all())
    d = ttf._tiled_render_bwd_torch(detached, only_sentinel, px, py, g, 3)
    assert all(bool(torch.isfinite(x).all()) and bool((x[:, :12] == 0).all()) for x in d)


def test_one_shard_equals_the_single_device_tiled_posterior(problems):
    """At one shard (no process group) the sharded tiled log-likelihood plus
    the rectangular prior is the single-device tiled posterior, value and
    gradient; the star padding's likelihood gradient is exactly 0."""
    for name, p in problems.items():
        cs = _scene(p)
        f = sharded_tiled_crowded_loglik(cs, p["tstamp"], 2, None, p["pos"], p["radius"],
                                         n_bands=5)
        ref, _ = make_tiled_crowded_logdensity(cs, p["tstamp"], 2, p["pos"], p["radius"],
                                               n_buckets=1)
        x = torch.as_tensor(p["vecs"]).requires_grad_(True)
        ll = f(x)
        (g_ll,) = torch.autograd.grad(ll.sum(), x)
        x2 = x.detach().clone().requires_grad_(True)
        (g_lp,) = torch.autograd.grad(crowded_rect_logprior(cs, x2).sum(), x2)
        xp = cs.from_rect(x.detach()).requires_grad_(True)
        want = ref(xp)
        (gw,) = torch.autograd.grad(want.sum(), xp)
        got = ll.detach() + crowded_rect_logprior(cs, x.detach())
        torch.testing.assert_close(got, want.detach(), rtol=2e-6, atol=1.0)
        torch.testing.assert_close(cs.from_rect(g_ll + g_lp), gw, **GRAD_TOL)
        for i, kind in enumerate(cs.kinds):
            if kind == "star":
                assert bool((g_ll[:, i, 7:] == 0).all())


# ---------------------------------------------------------------------------
# the sharded worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_values(problems):
    """JAX's sharded log-likelihoods on the virtual mesh of each shape."""
    out = {}
    for shape, sizes in MESHES.items():
        mesh = j_make_mesh(sizes)
        for name, p in problems.items():
            tiled = j_sharded_tiled(p["jscene"], p["jstamp"], 2, mesh, p["pos"],
                                    radii_px=p["radius"])
            dense = j_sharded_dense(p["jscene"], p["jstamp"], 2, mesh)
            v = jnp.asarray(p["vecs"])
            with mesh:
                out[shape, name, "tiled"] = np.asarray(jax.jit(tiled)(v))
                out[shape, name, "dense"] = np.asarray(jax.jit(dense)(v))
    return out


@pytest.mark.parametrize("which", ["tiled", "dense"])
@pytest.mark.parametrize("scene", ["mixed", "stars"])
@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_sharded_loglik_matches_jax(worlds, jax_values, shape, scene, which):
    got = _by_chains(worlds[shape], scene, which)
    tol = TILED_TOL if which == "tiled" else DENSE_TOL
    np.testing.assert_allclose(got, jax_values[shape, scene, which], **tol)


@pytest.mark.parametrize("scene", ["mixed", "stars"])
@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_sharded_gradient_equals_single_process(problems, worlds, shape, scene):
    """Every rank's gradient of its chains equals the one-process gradient,
    at 2 and at 4 source shards (a gradient summed once more over the
    shards would be 2x or 4x)."""
    p = problems[scene]
    cs = _scene(p)
    f = sharded_tiled_crowded_loglik(cs, p["tstamp"], 2, None, p["pos"], p["radius"])
    x = torch.as_tensor(p["vecs"]).requires_grad_(True)
    (want,) = torch.autograd.grad(f(x).sum(), x)
    got = _by_chains(worlds[shape], scene, "grad")
    np.testing.assert_allclose(got, want.numpy(), **GRAD_TOL)
    assert np.abs(want.numpy()).max() > 10.0
    np.testing.assert_allclose(_by_chains(worlds[shape], scene, "tiled"),
                               f(x).detach().numpy(), rtol=2e-6, atol=1.0)


def test_bucketed_sharded_path_equals_unbucketed(worlds):
    """The 64-star field at 4 source shards: 3 occupancy buckets give the
    1-bucket likelihood with less kernel work (tests/test_parallel.py:453)."""
    for r in worlds["1x4"]:
        b = r["buckets"]
        np.testing.assert_allclose(b[3], b[1], rtol=1e-6, atol=0.2)
        assert b["work3"] < 0.7 * b["work1"], (b["work3"], b["work1"])
    vals = [r["buckets"][1] for r in worlds["1x4"]]
    assert all(np.array_equal(v, vals[0]) for v in vals) and np.all(np.isfinite(vals[0]))


def test_collectives_semantics(worlds):
    """tests/test_collectives.py:23-58 over a mesh dimension of 4 ranks, and
    the two gradient conjugates."""
    res = sorted((r["collectives"] for r in worlds["1x4"]), key=lambda c: c["index"])
    assert [c["index"] for c in res] == [0, 1, 2, 3]
    for i, c in enumerate(res):
        assert c["sum"] == 6.0 and c["mean"] == 1.5
        assert c["ring"] == (i - 1) % 4 and c["ring_back"] == (i + 1) % 4
        assert c["neighbor"] == [1, 0, 3, 2][i]
        np.testing.assert_array_equal(c["gather"], [0.0, 1.0, 2.0, 3.0])
        assert c["sum_over"] == 10.0 and c["sum_over_grad"] == 3.0
        np.testing.assert_array_equal(c["replicated_grad"], [1.0, 2.0, 3.0, 4.0])


def test_sharded_ensemble_equals_single_process(worlds):
    """Sharded MH over 2 chain shards is the same Markov chain as one
    process running all 16 chains (tests/test_parallel.py:54-68)."""
    from celeste_tpu_torch.inference import mh_init, mh_kernel, run_chains_ensemble

    x0 = torch.as_tensor(_ensemble_start())
    kern = mh_kernel(w.gauss_logdensity, torch.full((w.GAUSS_D,), w.MH_SCALE))
    want, _, _ = run_chains_ensemble(torch.Generator().manual_seed(SEED), kern,
                                     mh_init(x0, w.gauss_logdensity), N_MH)
    ens = [r["ensemble"] for r in worlds["2x2"]]
    got = np.concatenate([e["mh"] for e in sorted(ens, key=lambda e: e["rows"])[::2]])
    assert got.shape == (16, N_MH, w.GAUSS_D)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


def test_sharded_chees_adapts_as_one_process(worlds):
    """run_sharded_chees's (eps, T) after the warmup equal chees_warmup's on
    the same 16 chains; every rank holds the same pair and the same pooled
    acceptance."""
    eps, traj = w.reference_chees(_ensemble_start(), SEED, N_CHEES)
    ens = [r["ensemble"] for r in worlds["2x2"]]
    for e in ens:
        np.testing.assert_allclose([e["eps"], e["traj"]], [eps, traj], rtol=1e-5)
        np.testing.assert_array_equal(e["accept"], ens[0]["accept"])
        assert np.all(np.isfinite(e["chees"]))


def test_dryrun_multichip_on_four_cpu_ranks():
    out = dryrun_multichip(4, device="cpu")
    assert set(out) == {"accept_rate", "mean_state_abs", "logp_mean", "grad_abs_max", "eps",
                        "traj", "pt_swaps_accepted", "pt_logp_cold", "field_groups",
                        "field_sources", "field_samples_mean"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["grad_abs_max"] > 0.0 and 0.0 <= out["accept_rate"] <= 1.0
    assert out["field_groups"] >= 2 and out["field_sources"] >= 2
