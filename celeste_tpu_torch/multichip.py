"""The sharded crowded field end to end on N ranks: the port of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py:138``), its crowded,
MH-step and ChEES parts.

    python -m celeste_tpu_torch.multichip [--world N] [--device cuda|cpu]
    torchrun --nproc-per-node N -m celeste_tpu_torch.multichip

On ``(chains, sources)`` = (N / s, s) ranks, s the largest of 4 and 2 that
divides N, every rank builds a mixed star/galaxy scene of 2 sources per
source shard on a 16x16 stamp, with 2 chains per chain shard, and runs:

- the source-sharded tiled log-likelihood (K5 and K6 on the card) and the
  dense one, on the rectangular state, with the rectangular prior;
- one MH update of the joint state and the ensemble reductions over
  ``chains`` (pooled acceptance, mean state, mean log density);
- a short ChEES warmup on a Gaussian, its statistics pooled over ``chains``;
- the tempering ladder sharded over every rank (a ``temps`` mesh, two
  replicas each) on a bimodal 2-D target, two steps so that both swap
  parities run: the all-reduce of the [T] log densities and the edge
  exchange cross ranks here; the ladder's log densities must be finite;
- the field pipeline's group shard (``__graft_entry__.py:297-326``): two
  disjoint fit groups of a 48x48 frame padded with dead groups to a
  multiple of the ranks on a ``groups`` mesh over every rank, tiny
  sampling knobs; the catalog's two sources and finite samples.

Without ``torchrun`` the
ranks are spawned on this host (``parallel.mesh.launch``): NCCL where each
rank has its own card, else gloo.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch


def _factor(n: int):
    """(chains, sources) shards of n ranks: sources take the largest of 4, 2
    that divides n."""
    sources = next((f for f in (4, 2) if n % f == 0), 1)
    return n // sources, sources


def _dryrun_rank(device_type: str):
    """One rank of the dry run; returns its diagnostics as floats."""
    import torch.distributed as dist

    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
    from celeste_tpu_torch.inference import chees_warmup
    from celeste_tpu_torch.parallel import (
        ChainShard, CrowdedScene, crowded_rect_logprior, make_mesh, sharded_crowded_loglik,
        sharded_tiled_crowded_loglik,
    )
    from celeste_tpu_torch.parallel.collectives import all_mean

    n_chain_shards, n_src_shards = _factor(dist.get_world_size())
    mesh = make_mesh({"chains": n_chain_shards, "sources": n_src_shards}, device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    n_src, n_chains = 2 * n_src_shards, 2 * n_chain_shards
    rng = np.random.default_rng(0)
    offs = [(rng.uniform(-3, 3), rng.uniform(-3, 3)) for _ in range(n_src)]
    kinds = tuple("galaxy" if i % 2 else "star" for i in range(n_src))
    srcs = []
    for i, (de, dn) in enumerate(offs):
        u = (30 + de / 3600 / np.cos(np.deg2rad(10)), 10 + dn / 3600)
        srcs.append(star_source(u=u, flux_r=20.0 + 3 * i) if kinds[i] == "star"
                    else galaxy_source(u=u, flux_r=30.0 + 3 * i, sigma=0.9))
    sd = make_synthetic_stamp(srcs, shape=(16, 16), bands=(2,), seed=1, device=device)
    cs = CrowdedScene(kinds=kinds, n_bands=5)
    stamp = sd.stamps[0]
    du = torch.as_tensor(np.stack([sd.wcs.equa2duas(s["u"]) for s in srcs]),
                         dtype=torch.float32, device=device)
    pos_px = stamp.duas2pixel(du).cpu().numpy()
    loglik = sharded_tiled_crowded_loglik(cs, stamp, 2, mesh, pos_px, radii_px=8.0)
    loglik_dense = sharded_crowded_loglik(cs, stamp, 2, mesh)

    rows = np.zeros((n_src, cs.rect_dim), np.float32)
    for row, s in zip(rows, srcs):
        row[:2] = sd.wcs.equa2duas(s["u"])
        row[2:7] = np.log(s["flux"])
        if s["type"] == "galaxy":
            th, ab = s["theta_dev"], s["ab"]
            row[7:11] = [np.log(th / (1 - th)), np.log(s["sigma"]), np.log(ab / (1 - ab)),
                         s["phi"]]
    chains = ChainShard(mesh, n_chains)
    vecs = torch.as_tensor(np.tile(rows[None], (n_chains, 1, 1)), device=device)[chains.rows]

    def logpost(v):
        return loglik(v) + crowded_rect_logprior(cs, v)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    with torch.no_grad():
        lp0 = logpost(vecs) + 0.0 * loglik_dense(vecs)       # both paths run
        prop = vecs + 0.01 * chains.normal(gen, vecs)
        lp1 = logpost(prop)
        accept = torch.log(chains.uniform(gen, lp0)) < lp1 - lp0
        new = torch.where(accept[:, None, None], prop, vecs)
    x = new.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(logpost(x).sum(), x)
    diag = {
        "accept_rate": all_mean(accept.float().mean(), mesh, "chains"),
        "mean_state_abs": all_mean(new.mean(0), mesh, "chains").abs().mean(),
        "logp_mean": all_mean(torch.where(accept, lp1, lp0).mean(), mesh, "chains"),
        "grad_abs_max": grad.abs().max(),
    }

    z0 = torch.as_tensor(rng.normal(size=(n_chains, 4)), dtype=torch.float32, device=device)
    _, eps, traj = chees_warmup(gen, lambda z: -0.5 * torch.sum(z * z, -1),
                                z0[chains.rows], n_warmup=5, max_leapfrog=8, chains=chains)
    out = {k: float(v) for k, v in diag.items()}
    out.update(eps=float(eps), traj=float(traj), **_dryrun_ladder(device_type, rng),
               **_dryrun_field(device_type))
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"dryrun_multichip: non-finite {bad} on rank {dist.get_rank()}")
    return out


def _bimodal(x):
    """Two Gaussian modes at (2, 2) and (-2, -2), variance 0.3: tempering matters."""
    return torch.logaddexp(-0.5 * torch.sum((x - 2.0) ** 2, -1) / 0.3,
                           -0.5 * torch.sum((x + 2.0) ** 2, -1) / 0.3)


def _dryrun_ladder(device_type: str, rng):
    """The ladder sharded over every rank (two replicas each), two MH steps;
    returns the swaps accepted and the cold log density."""
    import torch.distributed as dist

    from celeste_tpu_torch.inference.tempering import geometric_ladder, mh_at_beta
    from celeste_tpu_torch.parallel import make_mesh
    from celeste_tpu_torch.parallel.pt_sharded import (
        LadderShard, sharded_pt_init, sharded_pt_kernel,
    )

    mesh = make_mesh({"temps": dist.get_world_size()}, device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    n_temps = 2 * dist.get_world_size()
    betas = geometric_ladder(n_temps, beta_min=0.05, device=device)
    inner = mh_at_beta(_bimodal, torch.full((2,), 0.4, device=device),
                       noise=LadderShard(mesh, "temps", n_temps))
    kern = sharded_pt_kernel(_bimodal, inner, betas, mesh, "temps")
    xs = torch.as_tensor(rng.normal(size=(n_temps, 2)), dtype=torch.float32, device=device)
    state = sharded_pt_init(xs, _bimodal, mesh, "temps")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    accepted = 0
    with torch.no_grad():
        for _ in range(2):
            state, info = kern(gen, state)
            accepted += int(info.swap_accept.sum())
    if not bool(torch.isfinite(state.logps).all()):
        raise RuntimeError("dryrun_multichip: the sharded ladder's log densities are not finite")
    return {"pt_swaps_accepted": accepted, "pt_logp_cold": float(info.logp_cold)}


def _dryrun_field(device_type: str):
    """The field's fit groups sharded over every rank (a ``groups`` mesh),
    the JAX dry run's frame and knobs; returns the groups, the sources and
    the samples' mean."""
    import torch.distributed as dist

    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.parallel import make_mesh
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    mesh = make_mesh({"groups": dist.get_world_size()}, device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    cosd = np.cos(np.deg2rad(10))
    srcs = [star_source(u=(30.0 - 10 / 3600 / cosd, 10.0 - 10 / 3600), flux_r=60.0),
            star_source(u=(30.0 + 10 / 3600 / cosd, 10.0 + 10 / 3600), flux_r=45.0)]
    scene = make_synthetic_stamp(srcs, shape=(48, 48), bands=(2,), seed=9, device=device)
    cfg = FieldConfig(sample=True, seed=5, n_chains=4, probe_warmup=4, probe_steps=4, n_warmup=4,
                      n_steps=8, max_leapfrog=8, map_steps=30, type_switch=False, group_cut=16,
                      group_margin_px=6, detection_rounds=1)
    with open(os.devnull, "w") as quiet:
        cat, art = run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg,
                                      priors=SourcePriors(flux=FluxPrior(log_ref_mean=3.2,
                                                                         log_ref_std=2.0)),
                                      logger=MetricsLogger(stream=quiet), mesh=mesh)
    if art["n_groups"] < 2 or len(cat) < 2 or not np.isfinite(art["samples"]).all():
        raise RuntimeError(f"dryrun_multichip: the field's group shard found {art['n_groups']} "
                           f"groups, {len(cat)} sources, finite samples "
                           f"{bool(np.isfinite(art['samples']).all())}")
    return {"field_groups": art["n_groups"], "field_sources": len(cat),
            "field_samples_mean": float(np.mean(art["samples"]))}


def dryrun_multichip(world: int, device: str = "cuda"):
    """Run the dry run on ``world`` spawned ranks; returns rank 0's
    diagnostics.  ``device="cuda"`` raises where CUDA is absent."""
    from celeste_tpu_torch.experiments import resolve_device
    from celeste_tpu_torch.parallel.mesh import launch

    device_type = resolve_device(device).type
    backend = ("nccl" if device_type == "cuda" and world <= torch.cuda.device_count()
               else "gloo")
    return launch(_dryrun_rank, world, device_type, backend=backend)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=max(1, torch.cuda.device_count()))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:          # under torchrun: this process is one rank
        import torch.distributed as dist

        from celeste_tpu_torch.experiments import resolve_device

        device_type = resolve_device(args.device).type
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
        try:
            out = _dryrun_rank(device_type)
        finally:
            dist.destroy_process_group()
    else:
        out = dryrun_multichip(args.world, args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
