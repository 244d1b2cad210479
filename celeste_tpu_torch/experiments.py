"""Experiment configs + runner (counterpart of ``celeste_tpu/experiments.py``).

Ported so far:

  star_single    — BASELINE config 1: r-band point source on a 25x25
                   stamp, MH over (position, flux) as written.
  star_ugriz     — BASELINE config 2: the same star in five bands (ugriz),
                   HMC by default and the slice sampler it is held to;
                   ``color_prior=gmm`` takes the empirical colour mixture.
  galaxy         — BASELINE config 3: an exp/deV galaxy with its shape on a
                   31x31 r-band stamp, NUTS.
  crowded_field  — BASELINE config 5's setting: a joint multi-source field
                   sampled by a chain ensemble, ChEES in the whitened space
                   of a pooled dense metric by default; ``tiled=true`` takes
                   the block-sparse tiled likelihood, ``n_galaxies`` mixes
                   galaxies into the scene.  With several bands, as in the
                   JAX package, every band is rendered and the first
                   band's stamp is sampled with one flux per source.

Samplers: mh, slice, hmc, nuts and chees; the gradient samplers after an
adaptive HMC warmup; ``metric=dense`` samples in the whitened space.  The
other configs of the JAX package, the tempered samplers and
checkpoint/resume raise "not yet ported" (ROADMAP.md lists them).

Run:  python -m celeste_tpu_torch.run config=star_single n_chains=64 n_steps=2000
      python -m celeste_tpu_torch.run config=star_ugriz sampler=slice color_prior=gmm
      python -m celeste_tpu_torch.run config=galaxy
      python -m celeste_tpu_torch.run config=crowded_field tiled=true n_galaxies=2
Flat ``key=value`` overrides are parsed onto the dataclass.  ``device``
defaults to ``cuda`` and raises where CUDA is absent; ``device=cpu`` runs
the plain PyTorch path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ExperimentConfig:
    name: str = "star_single"
    sampler: str = "mh"            # mh | slice | hmc | nuts | chees
    n_chains: int = 64
    n_steps: int = 1000
    n_warmup: int = 300
    thin: int = 1
    seed: int = 0
    # scene
    shape: tuple = (25, 25)
    flux_r: float = 30.0
    n_sources: int = 1
    bands: tuple = (2,)
    # sampler knobs
    step_size: float = 0.0         # 0 = auto (warmup adaptation)
    max_depth: int = 6
    n_leapfrog: int = 16
    metric: str = "diag"           # diag | dense (pooled ensemble whitening)
    color_prior: str = "gaussian"  # gaussian | gmm (empirical colour GMM)
    tiled: bool = False            # crowded_field: block-sparse tiled loglik
    n_galaxies: int = 0            # crowded_field: mixed star/galaxy scenes
    # io
    out: str = ""
    checkpoint_every: int = 0      # not yet ported: must stay 0
    resume: str = ""               # not yet ported: must stay ""
    device: str = "cuda"


def _coerce(val: str, target_type):
    if target_type is bool:
        return val.lower() in ("1", "true", "yes")
    if target_type is tuple:
        return tuple(int(x) for x in val.strip("()").split(",") if x)
    try:
        return target_type(val)
    except (TypeError, ValueError):
        return val


def parse_overrides(cfg: ExperimentConfig, argv):
    fields = {f.name for f in dataclasses.fields(cfg)}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"override must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        if k == "config":
            continue
        if k not in fields:
            raise SystemExit(f"unknown config key {k!r}; known: {sorted(fields)}")
        current = getattr(cfg, k)
        t = type(current) if current is not None else str
        setattr(cfg, k, _coerce(v, t))
    return cfg


CONFIGS = {
    "star_single": ExperimentConfig(name="star_single", sampler="mh", n_chains=64,
                                    n_steps=3000, bands=(2,)),
    "star_ugriz": ExperimentConfig(name="star_ugriz", sampler="hmc", n_chains=32,
                                   n_steps=1000, bands=(0, 1, 2, 3, 4)),
    "galaxy": ExperimentConfig(name="galaxy", sampler="nuts", n_chains=32, n_steps=800,
                               shape=(31, 31), flux_r=60.0, bands=(2,)),
    # chees + dense metric: the JAX package's measured-best crowded sampler;
    # sampler=nuts metric=diag restores the reference-style configuration
    "crowded_field": ExperimentConfig(name="crowded_field", sampler="chees", metric="dense",
                                      n_chains=256, n_steps=500, shape=(41, 41),
                                      n_sources=10, bands=(2,)),
}


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; a CUDA device where CUDA is absent
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} needs CUDA, which is not available; "
                           f"pass device=cpu to run the plain PyTorch path")
    return device


def _flux_priors(cfg: ExperimentConfig, default_gmm):
    """Log-normal reference flux around ``flux_r``; Gaussian colours, or the
    empirical colour mixture ``default_gmm()`` when ``color_prior=gmm``."""
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    color_gmm = default_gmm() if cfg.color_prior == "gmm" else None
    return SourcePriors(flux=FluxPrior(log_ref_mean=float(np.log(cfg.flux_r)), log_ref_std=2.0,
                                       color_gmm=color_gmm))


def _star_problem(cfg: ExperimentConfig, device):
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.inference.problems import make_star_logdensity
    from celeste_tpu_torch.model.color_prior import default_star_gmm

    src = star_source(u=(30.00005, 10.00008), flux_r=cfg.flux_r)
    scene = make_synthetic_stamp([src], shape=cfg.shape, bands=cfg.bands, seed=cfg.seed,
                                 device=device)
    nb = len(cfg.bands)
    # the vector is [du_e, du_n, log_flux per band]; stamp i's flux slot is i
    logd = make_star_logdensity(scene.stamps, bands=list(range(nb)),
                                priors=_flux_priors(cfg, default_star_gmm), n_bands=nb)
    du = scene.wcs.equa2duas(src["u"])
    x0 = np.concatenate([du, np.log([src["flux"][b] for b in cfg.bands])]).astype(np.float32)
    return scene, logd, x0


def _galaxy_problem(cfg: ExperimentConfig, device):
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp
    from celeste_tpu_torch.inference.problems import make_galaxy_logdensity
    from celeste_tpu_torch.model.color_prior import default_galaxy_gmm

    src = galaxy_source(u=(30.0, 10.0), flux_r=cfg.flux_r)
    scene = make_synthetic_stamp([src], shape=cfg.shape, bands=cfg.bands, seed=cfg.seed,
                                 device=device)
    nb = len(cfg.bands)
    logd = make_galaxy_logdensity(scene.stamps, bands=list(range(nb)),
                                  priors=_flux_priors(cfg, default_galaxy_gmm), n_bands=nb)
    du = scene.wcs.equa2duas(src["u"])
    t, ab = src["theta_dev"], src["ab"]
    x0 = np.concatenate([
        du, np.log([src["flux"][b] for b in cfg.bands]),
        [np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)), src["phi"]],
    ]).astype(np.float32)
    return scene, logd, x0


def _crowded_problem(cfg: ExperimentConfig, device):
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
    from celeste_tpu_torch.parallel.crowded import (
        CrowdedScene, make_crowded_logdensity, make_tiled_crowded_logdensity,
    )

    rng = np.random.default_rng(cfg.seed)
    half = cfg.shape[0] * 0.396 / 2.0 - 2.0
    n_gal = min(cfg.n_galaxies, cfg.n_sources)
    kinds = tuple("galaxy" if i < n_gal else "star" for i in range(cfg.n_sources))
    srcs = []
    for i in range(cfg.n_sources):
        de, dn = rng.uniform(-half, half, 2)
        u = (30 + de / 3600 / np.cos(np.deg2rad(10)), 10 + dn / 3600)
        if kinds[i] == "galaxy":
            srcs.append(galaxy_source(u=u, flux_r=2.0 * cfg.flux_r, sigma=0.8, ab=0.6))
        else:
            srcs.append(star_source(u=u, flux_r=cfg.flux_r * rng.uniform(0.5, 2.0)))
    scene = make_synthetic_stamp(srcs, shape=cfg.shape, bands=cfg.bands, seed=cfg.seed,
                                 device=device)
    cs = CrowdedScene(kinds=kinds, n_bands=1)
    stamp = scene.stamps[0]
    if cfg.tiled:
        # BASELINE config 5's production path: block-sparse tiles with
        # per-block amplitude-aware support radii
        from celeste_tpu_torch.model.galaxy import block_support_radii

        du = torch.as_tensor(np.stack([scene.wcs.equa2duas(s["u"]) for s in srcs]),
                             dtype=torch.float32, device=device)
        pos_px = stamp.duas2pixel(du).cpu().numpy()
        psf_sig = float(np.sqrt(np.max(np.linalg.eigvalsh(stamp.psf.cov.cpu().numpy()))))
        radii = block_support_radii(kinds, psf_sigma_px=psf_sig, gal_sigma_px=1.5 * 0.8 / 0.396)
        logd, _ = make_tiled_crowded_logdensity(cs, stamp, band=0, positions_px=pos_px,
                                                radii_px=radii)
    else:
        logd = make_crowded_logdensity(cs, [stamp], bands=[0])
    parts = []
    for s_, kind in zip(srcs, kinds):
        du = scene.wcs.equa2duas(s_["u"])
        if kind == "star":
            parts.append(np.concatenate([du, [np.log(s_["flux"][cfg.bands[0]])]]))
        else:
            th, ab = s_["theta_dev"], s_["ab"]
            parts.append(np.concatenate(
                [du, [np.log(s_["flux"][cfg.bands[0]]), np.log(th / (1 - th)),
                      np.log(s_["sigma"]), np.log(ab / (1 - ab)), s_["phi"]]]))
    x0 = np.concatenate(parts).astype(np.float32)
    return scene, logd, x0


_PROBLEMS = {"star_single": _star_problem, "star_ugriz": _star_problem,
             "galaxy": _galaxy_problem, "crowded_field": _crowded_problem}


def _check_ported(cfg: ExperimentConfig):
    if cfg.name not in _PROBLEMS:
        raise NotImplementedError(f"config {cfg.name!r} is not yet ported to "
                                  f"celeste_tpu_torch (see ROADMAP.md)")
    if cfg.sampler not in ("mh", "slice", "hmc", "nuts", "chees"):
        raise NotImplementedError(f"sampler {cfg.sampler!r} is not yet ported")
    if cfg.metric not in ("diag", "dense"):
        raise ValueError(f"metric must be diag or dense, got {cfg.metric!r}")
    if cfg.color_prior not in ("gaussian", "gmm"):
        raise ValueError(f"color_prior must be gaussian or gmm, got {cfg.color_prior!r}")
    if cfg.name == "crowded_field" and cfg.color_prior != "gaussian":
        raise NotImplementedError("color_prior=gmm is wired for the star and galaxy problems "
                                  "only; the crowded-field priors would need per-kind flux "
                                  "priors: rerun with color_prior=gaussian")
    if cfg.checkpoint_every or cfg.resume:
        raise NotImplementedError("checkpoint/resume is not yet ported")
    if cfg.sampler == "chees" and cfg.thin != 1:
        raise ValueError("the chees sampler does not support thinning")


def _dense_metric(cfg, gen, logd, states, step_size, inv_mass, logger):
    """Pool a dense metric from a short NUTS probe with the diagonal metric,
    whiten, and re-warm the step size in z-space.  Returns the z-space
    (logd, states, step size, unit inverse mass) and the map back to x."""
    from celeste_tpu_torch.inference import dense_metric_from_probe

    out = dense_metric_from_probe(gen, logd, states, step_size, inv_mass,
                                  probe_steps=min(16, max(4, cfg.n_warmup // 8)),
                                  n_zwarm=max(20, cfg.n_warmup // 5),
                                  n_leapfrog=cfg.n_leapfrog, max_depth=cfg.max_depth)
    logger.log("dense_metric", step_size=out["step_z"])
    return out["logd_z"], out["states_z"], out["step_z"], torch.ones_like(inv_mass), out["to_x"]


def run_experiment(cfg: ExperimentConfig):
    """Execute one experiment; returns a results dict (also written to
    ``cfg.out`` if set)."""
    from celeste_tpu_torch.inference import (
        chees_warmup, hmc_kernel, hmc_warmup, mh_init, mh_kernel, nuts_kernel,
        run_chains_ensemble, run_chees_ensemble, slice_init, slice_kernel, summarize,
    )
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    _check_ported(cfg)
    device = resolve_device(cfg.device)
    logger = MetricsLogger(cfg.out + ".metrics.jsonl" if cfg.out else None)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.log("start", config=dataclasses.asdict(cfg) | {"device_kind": kind})

    scene, logd, x0 = _PROBLEMS[cfg.name](cfg, device)
    d = x0.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    kw = dict(dtype=torch.float32, device=device)
    x0b = (torch.as_tensor(x0, **kw)[None, :]
           + 0.01 * torch.randn((cfg.n_chains, d), generator=gen, **kw))

    result = {}
    to_x = None
    with torch.no_grad():
        if cfg.sampler == "mh":
            kern = mh_kernel(logd, step_scales=torch.full((d,), 0.01, **kw))
            init = mh_init(x0b, logd)
        elif cfg.sampler == "slice":
            kern = slice_kernel(logd, widths=torch.full((d,), 0.05, **kw))
            init = slice_init(x0b, logd)
        else:
            init, ss, im = hmc_warmup(gen, logd, x0b, n_warmup=cfg.n_warmup,
                                      n_leapfrog=cfg.n_leapfrog)
            # one step size per chain was adapted; sample with their median
            step_size = cfg.step_size or float(torch.quantile(ss, 0.5))
            inv_mass = torch.mean(im, dim=0)
            logger.log("warmup", step_size=step_size)
            if cfg.metric == "dense":
                logd, init, step_size, inv_mass, to_x = _dense_metric(
                    cfg, gen, logd, init, step_size, inv_mass, logger)
            result["step_size"] = step_size
            if cfg.sampler == "hmc":
                kern = hmc_kernel(logd, step_size, inv_mass, n_leapfrog=cfg.n_leapfrog)
            elif cfg.sampler == "nuts":
                kern = nuts_kernel(logd, step_size, inv_mass, max_depth=cfg.max_depth)
            else:
                # ensemble-adaptive jittered HMC: joint (eps, T) adaptation
                # pooled across the chains; it assumes unit mass, which the
                # dense metric supplies
                init, eps, traj = chees_warmup(gen, logd, init.x,
                                               n_warmup=max(100, cfg.n_warmup // 2),
                                               init_step_size=step_size,
                                               max_leapfrog=4 * cfg.n_leapfrog)
                result["step_size"], result["trajectory_length"] = float(eps), float(traj)
                logger.log("chees_warmup", step_size=float(eps), trajectory_length=float(traj))
        if cfg.sampler == "chees":
            samples, _, info = run_chees_ensemble(
                gen, logd, init, n_steps=cfg.n_steps, step_size=result["step_size"],
                trajectory_length=result["trajectory_length"], max_leapfrog=4 * cfg.n_leapfrog)
            accept, diverged = info.accept_rate, info.divergence_rate
        else:
            samples, _, info = run_chains_ensemble(gen, kern, init, n_steps=cfg.n_steps,
                                                   thin=cfg.thin)
            accept = (None if cfg.sampler == "slice"
                      else info.accept_prob if cfg.sampler == "nuts" else info.accepted)
            diverged = info.diverged if cfg.sampler == "nuts" else None
            if cfg.sampler == "slice":
                result["evals_per_sweep"] = float(torch.mean(info.n_evals.double()))
                result["calls_per_sweep"] = float(torch.mean(info.n_calls[0].double()))
        if to_x is not None:
            samples = to_x(samples)
        kept = samples[:, samples.shape[1] // 4:]
        summ = summarize(kept)
        if accept is not None:
            result["accept_rate"] = float(torch.mean(accept.to(torch.float32)))
        if diverged is not None:
            result["divergence_rate"] = float(torch.mean(diverged.to(torch.float32)))
    logger.log("done", rhat_max=float(torch.max(summ["rhat"])),
               ess_min=float(torch.min(summ["ess"])), accept_rate=result.get("accept_rate"),
               mean=summ["mean"], std=summ["std"])
    logger.close()
    result.update({"samples": samples.cpu().numpy(), "x0": x0,
                   "mean": summ["mean"].cpu().numpy(), "std": summ["std"].cpu().numpy(),
                   "rhat": summ["rhat"].cpu().numpy(), "ess": summ["ess"].cpu().numpy()})
    if cfg.out:
        np.savez(cfg.out, **result)
    return result
