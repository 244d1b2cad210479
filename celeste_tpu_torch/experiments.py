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

  quasar_photoz  — BASELINE config 4: the photometric-redshift posterior of a
                   quasar's ugriz fluxes, slice sampling within a tempered
                   ladder (``sampler=tempered_slice``, ``n_temps``, ``z_max``).
  pipeline       — the stamp catalog pipeline (``pipeline.run_pipeline``): a
                   33x33 r-band stamp with two stars and a galaxy, from
                   pixels to a posterior catalog (detect, classify, type
                   switch, joint ChEES, catalog; ``ppc=true`` adds the
                   posterior-predictive check, ``type_switch=false`` keeps
                   the margin rule for every candidate).
  field          — the field-scale catalog pipeline (``field.run_field_pipeline``)
                   on a 96x96 frame with three isolated stars and a
                   star/galaxy blend: detection, grouping, classification
                   on cutouts, every fit group sampled in one batch.
  field_survey   — the survey-realism frame (``bench/field_scale.py``):
                   256x1024, ~60 mixed sources with blended pairs, the
                   field pipeline and the accuracy report against the
                   synthetic truth; ``sample=false`` runs the MAP scan.

Samplers: mh, slice, hmc, nuts and chees; the gradient samplers after an
adaptive HMC warmup; ``metric=dense`` samples in the whitened space.
``checkpoint_every=K`` (with ``out``) saves the sampler state every K
steps to ``out + ".ckpt.npz"`` and the samples so far beside it;
``resume=<ckpt>`` continues such a run bitwise, since every segment draws
from its own stream (seed, segment) and the warmup from its own.  The
field configs take ``sample_segment=K`` (steps per sampling segment) and
``resume=<path>``: the segmented sampling stage checkpoints there at every
boundary, and a rerun with the same path resumes bitwise.

Run:  python -m celeste_tpu_torch.run config=star_single n_chains=64 n_steps=2000
      python -m celeste_tpu_torch.run config=star_ugriz sampler=slice color_prior=gmm
      python -m celeste_tpu_torch.run config=galaxy
      python -m celeste_tpu_torch.run config=crowded_field tiled=true n_galaxies=2
      python -m celeste_tpu_torch.run config=quasar_photoz
      python -m celeste_tpu_torch.run config=pipeline ppc=true
      python -m celeste_tpu_torch.run config=field
      python -m celeste_tpu_torch.run config=field_survey sample=false
      python -m celeste_tpu_torch.run config=star_single checkpoint_every=500 out=run1
      python -m celeste_tpu_torch.run config=star_single checkpoint_every=500 \
          resume=run1.ckpt.npz out=run2
Flat ``key=value`` overrides are parsed onto the dataclass.  ``device``
defaults to ``cuda`` and raises where CUDA is absent; ``device=cpu`` runs
the plain PyTorch path.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ExperimentConfig:
    name: str = "star_single"
    sampler: str = "nuts"          # mh | slice | hmc | nuts | chees | tempered_slice
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
    # pipeline knobs
    ppc: bool = False              # posterior-predictive check stage
    type_switch: bool = True       # exact Carlin-Chib for ambiguous kinds
    # field: sampling steps per segment (0 = one segment per phase); with
    # ``resume=<path>`` the segmented stage checkpoints there at every
    # boundary and a rerun resumes bitwise (celeste_tpu_torch/field.py)
    sample_segment: int = 0
    # field_survey: False -> MAP-only catalog scan
    sample: bool = True
    # quasar
    n_temps: int = 8
    z_max: float = 6.0
    # io
    out: str = ""
    checkpoint_every: int = 0      # steps per segment; a checkpoint after each (needs out)
    resume: str = ""               # a checkpoint to continue from
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
    "quasar_photoz": ExperimentConfig(name="quasar_photoz", sampler="tempered_slice",
                                      n_chains=8, n_steps=1500, n_warmup=500),
    # sampler="nuts" as in the JAX package, whose pipeline config does not
    # pass it on: the pipeline samples with its own default, ChEES
    "pipeline": ExperimentConfig(name="pipeline", sampler="nuts", n_chains=16, n_steps=400,
                                 n_warmup=200, shape=(33, 33), n_sources=3, bands=(2,)),
    # the field-scale catalog pipeline: a synthetic frame with isolated
    # sources and a blend; detection, grouping and classification are the
    # frame's own, sampling one batch over groups x chains
    "field": ExperimentConfig(name="field", sampler="chees", n_chains=32, n_steps=300,
                              n_warmup=100, shape=(96, 96), n_sources=5, bands=(2,)),
    # the survey-realism frame (bench/field_scale.py): 256x1024, ~60 mixed
    # sources with blended pairs, the accuracy report against the truth
    "field_survey": ExperimentConfig(name="field_survey", sampler="chees", n_chains=8,
                                     n_steps=96, n_warmup=48, shape=(256, 1024),
                                     n_sources=60, bands=(2,)),
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
# the random streams of a run (utils.rng paths under cfg.seed): the start and
# warmup draw from one, sampling segment s from (_SEGMENT, s)
_WARMUP, _SEGMENT = 0, 1


def _check_ported(cfg: ExperimentConfig):
    if cfg.name == "quasar_photoz":
        if cfg.sampler != "tempered_slice":
            raise ValueError(f"quasar_photoz samples with sampler=tempered_slice, "
                             f"got {cfg.sampler!r}")
        return
    if cfg.name in ("pipeline", "field", "field_survey"):
        return
    if cfg.name not in _PROBLEMS:
        raise NotImplementedError(f"config {cfg.name!r} is not yet ported to "
                                  f"celeste_tpu_torch (see ROADMAP.md)")
    if cfg.sampler not in ("mh", "slice", "hmc", "nuts", "chees"):
        raise ValueError(f"sampler {cfg.sampler!r} is not one of mh, slice, hmc, nuts, chees")
    if cfg.metric not in ("diag", "dense"):
        raise ValueError(f"metric must be diag or dense, got {cfg.metric!r}")
    if cfg.color_prior not in ("gaussian", "gmm"):
        raise ValueError(f"color_prior must be gaussian or gmm, got {cfg.color_prior!r}")
    if cfg.name == "crowded_field" and cfg.color_prior != "gaussian":
        raise NotImplementedError("color_prior=gmm is wired for the star and galaxy problems "
                                  "only; the crowded-field priors would need per-kind flux "
                                  "priors: rerun with color_prior=gaussian")
    if cfg.sampler == "chees" and cfg.thin != 1:
        raise ValueError("the chees sampler does not support thinning")
    seg = cfg.checkpoint_every if cfg.checkpoint_every > 0 else cfg.n_steps
    if cfg.n_steps % seg:
        raise ValueError(f"checkpoint_every={seg} must divide n_steps={cfg.n_steps}")
    if seg % cfg.thin:
        raise ValueError(f"thin={cfg.thin} must divide the segment length {seg}")


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


def _quasar_photoz(cfg: ExperimentConfig, device, logger):
    """Config 4: fluxes of one quasar at a random redshift, made from
    ``default_rng(cfg.seed)`` exactly as the JAX package makes them, and the
    tempered slice sampler's cold-chain redshifts."""
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, project_to_bands, run_photo_z, sdss_like_filterbank,
        synthetic_template_basis,
    )

    basis = synthetic_template_basis(device=device)
    filters = sdss_like_filterbank(device=device)
    rng = np.random.default_rng(cfg.seed)
    z_true = rng.uniform(0.5, 4.0)
    w_true = torch.as_tensor(rng.dirichlet(np.full(basis.n_basis, 0.7)), dtype=torch.float32,
                             device=device)
    flux = project_to_bands(basis, filters, w_true, 2.0, z_true).cpu().numpy()
    err = 0.04 * np.abs(flux) + 1e-5
    obs = flux + rng.normal(size=5) * err
    pz = PhotoZConfig(n_temps=cfg.n_temps, n_steps=cfg.n_steps, n_warmup=cfg.n_warmup,
                      n_systems=cfg.n_chains, z_max=cfg.z_max)
    out = run_photo_z(cfg.seed, basis, filters, obs, err, pz, device=device)
    result = {"z": out["z"].cpu().numpy(), "z_true": z_true,
              "swap_rate": float(out["swap_rate"]),
              "calls_per_sweep": float(out["calls_per_sweep"])}
    logger.log("done", z_true=z_true, z_median=float(np.median(result["z"])),
               swap_rate=result["swap_rate"], calls_per_sweep=result["calls_per_sweep"])
    return result


def pipeline_scene(cfg: ExperimentConfig, device):
    """The ``pipeline`` config's field, as the JAX package makes it: two
    stars and a galaxy a few arcsec apart, counts from seed + 101.  Returns
    (scene, sources)."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    cosd = np.cos(np.deg2rad(10.0))
    srcs = [
        star_source(u=(30.0 - 3.5 / 3600 / cosd, 10.0 - 2.0 / 3600), flux_r=35.0),
        star_source(u=(30.0 + 3.0 / 3600 / cosd, 10.0 + 2.5 / 3600), flux_r=25.0),
        galaxy_source(u=(30.0, 10.0), flux_r=70.0, sigma=1.8, ab=0.6),
    ]
    scene = make_synthetic_stamp(srcs, shape=cfg.shape, bands=cfg.bands, seed=cfg.seed + 101,
                                 device=device)
    return scene, srcs


def _pipeline(cfg: ExperimentConfig, device, logger):
    """The stamp catalog pipeline on ``pipeline_scene``.  Like the JAX
    package, the ``PipelineConfig`` takes chains, steps, seed, ``ppc`` and
    ``type_switch`` from the experiment and keeps its own sampler (ChEES).
    Returns the catalog's kinds, P(star), positions and fluxes, the
    PPC p-values with ``ppc``, and the run itself (catalog, artifacts,
    scene, sources, priors)."""
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.pipeline import PipelineConfig, run_pipeline

    scene, srcs = pipeline_scene(cfg, device)
    pcfg = PipelineConfig(n_chains=cfg.n_chains, n_warmup=cfg.n_warmup, n_steps=cfg.n_steps,
                          seed=cfg.seed, detection_min_separation=7, ppc=cfg.ppc,
                          type_switch=cfg.type_switch)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    catalog, artifacts = run_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=pcfg,
                                      priors=priors, logger=logger)
    logger.log("done", n_sources=len(catalog), kinds=[e.kind for e in catalog])
    result = {
        "kinds": np.asarray([e.kind for e in catalog]),
        "p_star": np.asarray([e.p_star for e in catalog]),
        "du_mean": np.stack([e.du_mean for e in catalog]) if catalog else np.zeros((0, 2)),
        "flux_mean": np.stack([e.flux_mean for e in catalog]) if catalog else np.zeros((0, 1)),
    }
    if "ppc" in artifacts:
        result["ppc_pvalue"] = np.asarray([p["pvalue"] for p in artifacts["ppc"]])
    return result, {"catalog": catalog, "artifacts": artifacts, "scene": scene,
                    "sources": srcs, "priors": priors}


_FIELD_PRIORS = dict(log_ref_mean=3.2, log_ref_std=2.0)


def field_scene(cfg: ExperimentConfig, device):
    """The ``field`` config's frame, as the JAX package makes it: three
    isolated stars and a star/galaxy blend 2.4'' apart (the first
    ``n_sources`` of the five), counts from seed + 11.  Returns (scene,
    sources)."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    cosd = np.cos(np.deg2rad(10.0))
    asu = 1.0 / 3600.0
    srcs = [
        star_source(u=(30.0 - 14 * asu / cosd, 10.0 - 13 * asu), flux_r=60.0),
        star_source(u=(30.0 + 15 * asu / cosd, 10.0 - 11 * asu), flux_r=30.0),
        star_source(u=(30.0 - 12 * asu / cosd, 10.0 + 14 * asu), flux_r=45.0),
        star_source(u=(30.0 + 10 * asu / cosd, 10.0 + 12 * asu), flux_r=40.0),
        galaxy_source(u=(30.0 + 10 * asu / cosd, 10.0 + 14.4 * asu), flux_r=80.0, sigma=1.6,
                      ab=0.7),
    ][:max(cfg.n_sources, 1)]
    scene = make_synthetic_stamp(srcs, shape=cfg.shape, bands=cfg.bands, seed=cfg.seed + 11,
                                 device=device)
    return scene, srcs


def _field(cfg: ExperimentConfig, device, logger):
    """The field pipeline on ``field_scene`` (``field``) or the survey frame
    (``field_survey``), with the JAX package's settings, priors and result
    keys; the run itself (catalog, artifacts, scene, sources, and for the
    survey the accuracy report) comes back beside."""
    from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    priors = SourcePriors(flux=FluxPrior(**_FIELD_PRIORS))
    knobs = dict(n_chains=cfg.n_chains, n_warmup=cfg.n_warmup, n_steps=cfg.n_steps,
                 seed=cfg.seed, sample_segment=cfg.sample_segment or None,
                 checkpoint_path=cfg.resume or None)
    if cfg.name == "field_survey":
        from celeste_tpu_torch.bench.field_scale import (
            accuracy_report, make_survey_scene, survey_scene_cfg,
        )

        scene, srcs = make_survey_scene(shape=cfg.shape, device=device)
        fcfg = survey_scene_cfg(sample=cfg.sample, **knobs)
    else:
        scene, srcs = field_scene(cfg, device)
        fcfg = FieldConfig(type_switch=cfg.type_switch, **knobs)
    catalog, artifacts = run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=fcfg,
                                            priors=priors, logger=logger)
    du = np.stack([e.du_mean for e in catalog]) if catalog else np.zeros((0, 2))
    result = {"kinds": np.asarray([e.kind for e in catalog]), "du_mean": du}
    run = {"catalog": catalog, "artifacts": artifacts, "scene": scene, "sources": srcs,
           "priors": priors}
    if cfg.name == "field_survey":
        rep = accuracy_report(catalog, scene, srcs)
        logger.log("done", n_sources=len(catalog), n_groups=artifacts["n_groups"],
                   completeness=rep["completeness"], purity=rep["purity"],
                   pos_z_rms=rep["pos_z_rms"], flux_z_rms=rep["flux_z_rms"])
        result["accuracy"] = run["accuracy"] = rep
    else:
        logger.log("done", n_sources=len(catalog), n_groups=artifacts["n_groups"],
                   kinds=[e.kind for e in catalog])
        result["group"] = np.asarray([e.extras["group"] for e in catalog])
        result["flux_mean"] = (np.stack([e.flux_mean for e in catalog]) if catalog
                               else np.zeros((0, 1)))
    return result, run


def _save_segments(ckpt: str, chunks):
    """The samples so far beside the checkpoint, one array per segment,
    written atomically."""
    tmp = ckpt + ".segments.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"seg_{i}": c.cpu().numpy() for i, c in enumerate(chunks)})
    os.replace(tmp, ckpt + ".segments.npz")


def run_experiment(cfg: ExperimentConfig):
    """Execute one experiment; returns a results dict (also written to
    ``cfg.out`` if set).

    Sampling runs in segments of ``checkpoint_every`` steps (one segment
    without it); each segment draws from its own stream (seed, segment), so
    a run resumed from the checkpoint after segment s equals the unbroken
    run bitwise.  A resume reruns the warmup, whose stream is its own, and
    reloads the stored segments, so the summary covers the whole chain.
    ``quasar_photoz`` and ``pipeline`` run unsegmented, as in the JAX
    package; ``field`` and ``field_survey`` segment their sampling stage
    by ``sample_segment`` and checkpoint to ``resume``.  The results of
    ``pipeline``, ``field`` and ``field_survey`` also hold the catalog and
    the run's artifacts under ``"run"``.
    """
    from celeste_tpu_torch.inference import (
        chees_warmup, hmc_kernel, hmc_warmup, mh_init, mh_kernel, nuts_kernel,
        run_chains_ensemble, run_chees_ensemble, slice_init, slice_kernel, summarize,
    )
    from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from celeste_tpu_torch.utils.metrics import MetricsLogger
    from celeste_tpu_torch.utils.rng import seeded_generator

    _check_ported(cfg)
    device = resolve_device(cfg.device)
    logger = MetricsLogger(cfg.out + ".metrics.jsonl" if cfg.out else None)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.log("start", config=dataclasses.asdict(cfg) | {"device_kind": kind})
    if cfg.name in ("quasar_photoz", "pipeline", "field", "field_survey"):
        if cfg.name in ("quasar_photoz", "pipeline") and (cfg.checkpoint_every or cfg.resume):
            logger.log("checkpoint_ignored", note=f"{cfg.name} runs unsegmented")
        if cfg.name == "quasar_photoz":
            result, run = _quasar_photoz(cfg, device, logger), None
        elif cfg.name == "pipeline":
            result, run = _pipeline(cfg, device, logger)
        else:
            result, run = _field(cfg, device, logger)
        logger.close()
        if cfg.out:
            np.savez(cfg.out, **{k: v for k, v in result.items() if k != "accuracy"})
        if run is not None:
            result["run"] = run
        return result

    scene, logd, x0 = _PROBLEMS[cfg.name](cfg, device)
    d = x0.shape[0]
    gen = seeded_generator(device, cfg.seed, _WARMUP)
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

        seg = cfg.checkpoint_every if cfg.checkpoint_every > 0 else cfg.n_steps
        n_segments = cfg.n_steps // seg
        start_seg, chunks = 0, []
        if cfg.resume:
            init, start_seg, _ = load_checkpoint(cfg.resume, init)
            logger.log("resume", path=cfg.resume, segment=start_seg)
            seg_path = cfg.resume + ".segments.npz"
            if os.path.exists(seg_path):
                with np.load(seg_path) as f:
                    chunks = [torch.as_tensor(f[f"seg_{i}"], device=device)
                              for i in range(start_seg)]
            else:
                logger.log("resume_without_segments", path=seg_path,
                           note="statistics will cover post-resume samples only")

        state, infos = init, []
        for s_i in range(start_seg, n_segments):
            g = seeded_generator(device, cfg.seed, _SEGMENT, s_i)
            if cfg.sampler == "chees":
                samples_seg, state, info = run_chees_ensemble(
                    g, logd, state, n_steps=seg, step_size=result["step_size"],
                    trajectory_length=result["trajectory_length"],
                    max_leapfrog=4 * cfg.n_leapfrog, start_iter=s_i * seg)
            else:
                samples_seg, state, info = run_chains_ensemble(g, kern, state, n_steps=seg,
                                                               thin=cfg.thin)
            chunks.append(samples_seg if to_x is None else to_x(samples_seg))
            infos.append(info)
            if cfg.checkpoint_every > 0 and cfg.out:
                ckpt = cfg.out + ".ckpt.npz"
                save_checkpoint(ckpt, state, step=s_i + 1)
                _save_segments(ckpt, chunks)
                logger.log("checkpoint", segment=s_i + 1)
        if not chunks:
            raise SystemExit(
                f"nothing to run: checkpoint is at segment {start_seg} of {n_segments} and no "
                f"per-segment samples were found next to it; raise n_steps to continue the chain")
        if start_seg >= n_segments:
            logger.log("already_complete", segments=n_segments,
                       note="no new sampling; re-summarizing the stored chain")
        samples = torch.cat(chunks, dim=1)
        kept = samples[:, samples.shape[1] // 4:]
        summ = summarize(kept)
        if infos:
            # every info field's last axis is time: concatenate the segments run here
            info = type(infos[0])(*(torch.cat(f, dim=-1) for f in zip(*infos)))
            if cfg.sampler == "chees":
                accept, diverged = info.accept_rate, info.divergence_rate
            elif cfg.sampler == "nuts":
                accept, diverged = info.accept_prob, info.diverged
            elif cfg.sampler == "slice":
                accept = diverged = None
            else:
                accept, diverged = info.accepted, None
            if accept is not None:
                result["accept_rate"] = float(torch.mean(accept.to(torch.float32)))
            if diverged is not None:
                result["divergence_rate"] = float(torch.mean(diverged.to(torch.float32)))
            if cfg.sampler == "slice":
                result["evals_per_sweep"] = float(torch.mean(info.n_evals.double()))
                result["calls_per_sweep"] = float(torch.mean(info.n_calls[0].double()))
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
