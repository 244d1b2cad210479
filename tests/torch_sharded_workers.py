"""What the ranks of ``tests/test_torch_sharded.py`` run.  The ranks are
spawned processes (``celeste_tpu_torch.parallel.mesh.launch``) that import
this module by name, so it imports only the port and NumPy; the JAX
references stay in the pytest process.  Each function runs on every rank
and returns plain data (NumPy arrays, floats) to the test.

The scenes are those of the JAX package's sharding tests
(tests/test_parallel.py): a mixed scene of 2 galaxies and 2 stars on a
33x33 stamp, and 4 stars on a 31x31 stamp.  ``make_sources`` builds their
source dicts with either package's ``data.synthetic``.
"""

import numpy as np
import torch
import torch.distributed as dist

from celeste_tpu_torch.data import synthetic
from celeste_tpu_torch.inference import chees_warmup, mh_init, mh_kernel
from celeste_tpu_torch.parallel import (
    ChainShard,
    CrowdedScene,
    chain_sharding,
    collectives,
    make_mesh,
    run_sharded_chees,
    run_sharded_ensemble,
    sharded_crowded_loglik,
    sharded_tiled_crowded_loglik,
)
from celeste_tpu_torch.parallel.mesh import axis_index

COSD = np.cos(np.deg2rad(10.0))
# (kind, (east, north) offset in arcsec, source keywords)
SCENES = {
    "mixed": dict(kinds=("galaxy", "star", "galaxy", "star"), shape=(33, 33), seed=37,
                  radius=18.0, sources=[
                      ("galaxy", (-2.5, -1.5), dict(flux_r=70.0, sigma=1.1, ab=0.7, phi=0.4)),
                      ("star", (2.0, 1.0), dict(flux_r=35.0)),
                      ("galaxy", (1.0, -2.2), dict(flux_r=50.0, sigma=0.8, ab=0.5, phi=1.2)),
                      ("star", (-1.2, 2.4), dict(flux_r=25.0))]),
    "stars": dict(kinds=("star",) * 4, shape=(31, 31), seed=21, radius=14.0, sources=[
        ("star", (-2.0, -1.5), dict(flux_r=20.0)), ("star", (1.8, 1.2), dict(flux_r=28.0)),
        ("star", (0.2, 2.2), dict(flux_r=36.0)), ("star", (-1.4, 1.9), dict(flux_r=44.0))]),
}
BAND, N_BANDS = 2, 5
# the bucketed field: 64 stars, 48 clustered in one corner of 64x256
BUCKET_FIELD = dict(shape=(64, 256), seed=88, n_sources=64, radius=10.0)
# the Gaussian of the ensemble checks, and the chains' MH proposal scale
GAUSS_D, MH_SCALE = 3, 0.5


def make_sources(synth, name):
    """The scene's source dicts, built with ``synth`` (either package's
    ``data.synthetic`` module)."""
    out = []
    for kind, (de, dn), kw in SCENES[name]["sources"]:
        u = (30.0 + de / 3600 / COSD, 10.0 + dn / 3600)
        out.append(synth.star_source(u=u, **kw) if kind == "star"
                   else synth.galaxy_source(u=u, **kw))
    return out


def bucket_field_sources(synth):
    rng = np.random.default_rng(8)
    h, w = BUCKET_FIELD["shape"]
    out = []
    for i in range(BUCKET_FIELD["n_sources"]):
        if i < 48:
            px, py = rng.uniform(10, 80), rng.uniform(6, 30)
        else:
            px, py = rng.uniform(90, w - 10), rng.uniform(6, h - 6)
        de, dn = (px - (w - 1) / 2) * 0.396, (py - (h - 1) / 2) * 0.396
        out.append(synth.star_source(u=(30 + de / 3600 / COSD, 10 + dn / 3600),
                                     flux_r=15 + 5 * rng.random()))
    return out


def truth_rect(sd, kinds):
    """The sources' true rectangular state [S, 6 + N_BANDS]."""
    cs = CrowdedScene(kinds=tuple(kinds), n_bands=N_BANDS)
    rows = np.zeros((len(kinds), cs.rect_dim), np.float32)
    for row, src in zip(rows, sd.sources):
        row[:2] = sd.wcs.equa2duas(src["u"])
        row[2:7] = np.log(src["flux"])
        if src["type"] == "galaxy":
            th, ab = src["theta_dev"], src["ab"]
            row[7:11] = [np.log(th / (1 - th)), np.log(src["sigma"]), np.log(ab / (1 - ab)),
                         src["phi"]]
    return rows


def port_problem(name):
    """(CrowdedScene, stamp, positions_px) of a scene, in the port."""
    spec = SCENES[name]
    sd = synthetic.make_synthetic_stamp(make_sources(synthetic, name), shape=spec["shape"],
                                        bands=(2,), seed=spec["seed"])
    stamp = sd.stamps[0]
    du = torch.as_tensor(np.stack([sd.wcs.equa2duas(s["u"]) for s in sd.sources]),
                         dtype=torch.float32)
    return CrowdedScene(kinds=spec["kinds"], n_bands=N_BANDS), stamp, \
        stamp.duas2pixel(du).numpy()


def sharded_values_and_grads(mesh, name, vecs):
    """This rank's tiled and dense log-likelihoods of ``vecs`` [B, S, D]
    (every chain; the rank evaluates its own block) and the tiled one's
    gradient."""
    cs, stamp, pos = port_problem(name)
    tiled = sharded_tiled_crowded_loglik(cs, stamp, BAND, mesh, pos, SCENES[name]["radius"])
    dense = sharded_crowded_loglik(cs, stamp, BAND, mesh)
    x = torch.as_tensor(vecs)[chain_sharding(mesh, vecs.shape[0])].requires_grad_(True)
    val = tiled(x)
    (grad,) = torch.autograd.grad(val.sum(), x)
    with torch.no_grad():
        val_dense = dense(x)
    return {"tiled": val.detach().numpy(), "dense": val_dense.numpy(), "grad": grad.numpy()}


def bucketed_values(mesh, vecs):
    """The 64-star field's sharded tiled log-likelihood of ``vecs``, with 1
    and with 3 occupancy buckets, and each one's kernel work (the summed
    tiles x slot cap of its launches)."""
    h, w = BUCKET_FIELD["shape"]
    sd = synthetic.make_synthetic_stamp(bucket_field_sources(synthetic), shape=(h, w),
                                        bands=(2,), seed=BUCKET_FIELD["seed"])
    stamp = sd.stamps[0]
    du = torch.as_tensor(np.stack([sd.wcs.equa2duas(s["u"]) for s in sd.sources]),
                         dtype=torch.float32)
    pos = stamp.duas2pixel(du).numpy()
    cs = CrowdedScene(kinds=("star",) * BUCKET_FIELD["n_sources"], n_bands=N_BANDS)
    x = torch.as_tensor(vecs)[chain_sharding(mesh, vecs.shape[0])]
    out = {}
    for n in (1, 3):
        f = sharded_tiled_crowded_loglik(cs, stamp, BAND, mesh, pos, BUCKET_FIELD["radius"],
                                         n_buckets=n)
        with torch.no_grad():
            out[n] = f(x).numpy()
        out[f"work{n}"] = sum(b.tile_src.shape[0] * b.s_cap for b in f.buckets)
    return out


def collective_values(mesh, axis):
    """Each collective of ``collectives.py`` over ``axis`` on the rank's
    value ``i`` (its coordinate), and the two gradient conjugates."""
    i = axis_index(mesh, axis)
    x = torch.tensor([float(i)])
    out = {
        "index": i,
        "sum": float(collectives.all_reduce_sum(x, mesh, axis)),
        "mean": float(collectives.all_mean(x, mesh, axis)),
        "ring": float(collectives.ring_shift(x, mesh, axis, shift=1)),
        "ring_back": float(collectives.ring_shift(x, mesh, axis, shift=-1)),
        "neighbor": float(collectives.neighbor_exchange(x, mesh, axis)),
        "gather": collectives.gather_axis(x, mesh, axis).numpy().ravel(),
    }
    # sum_over: forward sums, backward passes the cotangent through once
    y = torch.tensor([float(i + 1)], requires_grad=True)
    s = collectives.sum_over(y, mesh, axis)
    (gy,) = torch.autograd.grad((3.0 * s).sum(), y)
    # replicated_in: forward identity, backward sums the ranks' cotangents
    z = torch.ones(4, requires_grad=True)
    r = collectives.replicated_in(z, mesh, axis)
    (gz,) = torch.autograd.grad(r[i].sum() * (i + 1), z)
    out.update(sum_over=float(s), sum_over_grad=float(gy), replicated_grad=gz.numpy())
    return out


def gauss_logdensity(x):
    return -0.5 * torch.sum(x * x, -1)


def ensemble_runs(mesh, x0, seed, n_mh, n_warmup):
    """The sharded MH ensemble (``n_mh`` steps) and ChEES warmup
    (``n_warmup`` steps) on a standard Gaussian from the ensemble's start
    ``x0`` [n_chains, D], with generators seeded ``seed``."""
    x0 = torch.as_tensor(x0)
    shard = ChainShard(mesh, x0.shape[0])
    kern = mh_kernel(gauss_logdensity, torch.full((GAUSS_D,), MH_SCALE), chains=shard)
    init = mh_init(x0, gauss_logdensity)
    gen = torch.Generator().manual_seed(seed)
    samples, _, _ = run_sharded_ensemble(gen, kern, init, n_mh, mesh)
    gen = torch.Generator().manual_seed(seed)
    chees, _, eps, traj, info = run_sharded_chees(gen, gauss_logdensity, x0, mesh,
                                                  n_warmup=n_warmup, n_steps=4, max_leapfrog=16)
    return {"mh": samples.numpy(), "rows": (shard.rows.start, shard.rows.stop),
            "eps": float(eps), "traj": float(traj), "chees": chees.numpy(),
            "accept": info.accept_rate.numpy()}


def reference_chees(x0, seed, n_warmup):
    """Single-process ``chees_warmup`` on the same chains and generator."""
    gen = torch.Generator().manual_seed(seed)
    _, eps, traj = chees_warmup(gen, gauss_logdensity, torch.as_tensor(x0),
                                n_warmup=n_warmup, max_leapfrog=16)
    return float(eps), float(traj)


def world_checks(mesh_shape, jobs):
    """Every rank of a world with mesh ``mesh_shape`` ({name: size}): run
    each job of ``jobs`` ({name: (function of this module, keyword
    arguments)}) with the mesh, and return {name: result} plus the rank's
    coordinates."""
    mesh = make_mesh(mesh_shape, "cpu")
    out = {"rank": dist.get_rank(),
           "coords": {a: axis_index(mesh, a) for a in mesh_shape}}
    for name, (fn, kw) in jobs.items():
        out[name] = fn(mesh, **kw)
    return out
