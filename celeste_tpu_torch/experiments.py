"""Experiment configs + runner (counterpart of ``celeste_tpu/experiments.py``).

Ported so far:

  star_single    — BASELINE config 1: r-band point source on a 25x25
                   stamp, MH over (position, flux) as written, or HMC with
                   its adaptive warmup (``sampler=hmc``).

Every other config of the JAX package, and the NUTS, ChEES and slice
samplers, the dense metric, multi-band scenes and checkpoint/resume, raise
"not yet ported" (ROADMAP.md lists them).

Run:  python -m celeste_tpu_torch.run config=star_single n_chains=64 n_steps=2000
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
    sampler: str = "mh"            # mh | hmc
    n_chains: int = 64
    n_steps: int = 1000
    n_warmup: int = 300
    thin: int = 1
    seed: int = 0
    # scene
    shape: tuple = (25, 25)
    flux_r: float = 30.0
    bands: tuple = (2,)
    # sampler knobs
    step_size: float = 0.0         # 0 = auto (warmup adaptation)
    n_leapfrog: int = 16
    metric: str = "diag"           # diag (dense is not yet ported)
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
}


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; a CUDA device where CUDA is absent
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} needs CUDA, which is not available; "
                           f"pass device=cpu to run the plain PyTorch path")
    return device


def _star_problem(cfg: ExperimentConfig, device):
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.inference.problems import make_star_logdensity
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    src = star_source(u=(30.00005, 10.00008), flux_r=cfg.flux_r)
    scene = make_synthetic_stamp([src], shape=cfg.shape, bands=cfg.bands, seed=cfg.seed,
                                 device=device)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=float(np.log(cfg.flux_r)),
                                         log_ref_std=2.0))
    # one band: the vector is [du_e, du_n, log_flux] and the stamp's flux slot is 0
    logd = make_star_logdensity(scene.stamps, bands=[0], priors=priors, n_bands=1)
    du = scene.wcs.equa2duas(src["u"])
    x0 = np.concatenate([du, [np.log(src["flux"][cfg.bands[0]])]]).astype(np.float32)
    return scene, logd, x0


def _check_ported(cfg: ExperimentConfig):
    if cfg.name != "star_single":
        raise NotImplementedError(f"config {cfg.name!r} is not yet ported to "
                                  f"celeste_tpu_torch (see ROADMAP.md)")
    if cfg.sampler not in ("mh", "hmc"):
        raise NotImplementedError(f"sampler {cfg.sampler!r} is not yet ported")
    if cfg.metric != "diag":
        raise NotImplementedError(f"metric={cfg.metric!r} (whitening) is not yet ported")
    if len(cfg.bands) != 1:
        raise NotImplementedError("multi-band star posteriors (config 2) are not yet ported")
    if cfg.checkpoint_every or cfg.resume:
        raise NotImplementedError("checkpoint/resume is not yet ported")


def run_experiment(cfg: ExperimentConfig):
    """Execute one experiment; returns a results dict (also written to
    ``cfg.out`` if set)."""
    from celeste_tpu_torch.inference import (
        hmc_kernel, hmc_warmup, mh_init, mh_kernel, run_chains_ensemble, summarize,
    )
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    _check_ported(cfg)
    device = resolve_device(cfg.device)
    logger = MetricsLogger(cfg.out + ".metrics.jsonl" if cfg.out else None)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.log("start", config=dataclasses.asdict(cfg) | {"device_kind": kind})

    scene, logd, x0 = _star_problem(cfg, device)
    d = x0.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    kw = dict(dtype=torch.float32, device=device)
    x0b = (torch.as_tensor(x0, **kw)[None, :]
           + 0.01 * torch.randn((cfg.n_chains, d), generator=gen, **kw))

    step_size = None
    with torch.no_grad():
        if cfg.sampler == "mh":
            kern = mh_kernel(logd, step_scales=torch.full((d,), 0.01, **kw))
            init = mh_init(x0b, logd)
        else:
            init, ss, im = hmc_warmup(gen, logd, x0b, n_warmup=cfg.n_warmup,
                                      n_leapfrog=cfg.n_leapfrog)
            # one step size per chain was adapted; sample with their median
            step_size = cfg.step_size or float(torch.quantile(ss, 0.5))
            inv_mass = torch.mean(im, dim=0)
            logger.log("warmup", step_size=step_size)
            kern = hmc_kernel(logd, step_size, inv_mass, n_leapfrog=cfg.n_leapfrog)
        samples, _, info = run_chains_ensemble(gen, kern, init, n_steps=cfg.n_steps,
                                               thin=cfg.thin)
        kept = samples[:, samples.shape[1] // 4:]
        summ = summarize(kept)
        accept_rate = float(torch.mean(info.accepted.to(torch.float32)))
    logger.log("done", rhat_max=float(torch.max(summ["rhat"])),
               ess_min=float(torch.min(summ["ess"])), accept_rate=accept_rate,
               mean=summ["mean"], std=summ["std"])
    logger.close()
    result = {"samples": samples.cpu().numpy(), "x0": x0,
              "mean": summ["mean"].cpu().numpy(), "std": summ["std"].cpu().numpy(),
              "rhat": summ["rhat"].cpu().numpy(), "ess": summ["ess"].cpu().numpy(),
              "accept_rate": accept_rate}
    if step_size is not None:
        result["step_size"] = step_size
    if cfg.out:
        np.savez(cfg.out, **result)
    return result
