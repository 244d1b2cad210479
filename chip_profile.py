#!/usr/bin/env python3
"""Where the device time of config 1 (``star_single``), configs 2 and 3
(``star_ugriz``, ``galaxy``), config 5 (the crowded field) and config 4
(quasar photo-z) and the stamp pipeline goes, on one NVIDIA GPU.

    python3 chip_profile.py [--iters N] [--out FILE] [--only TEXT]

Each call is run ``N`` times after a warm-up, first unprofiled (wall time
per call, CUDA synchronized) and then under ``torch.profiler`` with CUPTI
device tracing.  Config 1: the star log-density and its ``value_and_grad``
at B=64 (the sampling run's chains) and at B=65536 (the timing protocol of
``chip_smoke.py``), one HMC step of 16 leapfrog steps and one MH step at
B=64.  Configs 2 and 3: the five-band star and the 31x31 galaxy, each
log-density and ``value_and_grad`` at their 32 sampling chains.  Config 5
(12 sources, 48x128, tiled): the log-density and its
``value_and_grad`` at B=1024, one whitened ChEES ensemble step of
``CHEES_LEAPFROGS`` leapfrog steps at B=1024, the ``value_and_grad`` of
the source-sharded rectangular posterior on one rank (K5 and K6) at
B=1024, and the ``value_and_grad`` of the three-band field (g, r, i) at
B=1024.  Config 4 (quasar photo-z, the bench batch's shape): the
``value_and_grad`` of 256 targets x 6 temperatures (B=1536, the 8192-point
grid) and one ``hmc_adaptive`` tempered step of 8 leapfrog steps and the
swap sweep.  The stamp pipeline (the ``pipeline`` config's field): one
classify Adam step of its 6 folded conditional rows and the joint
posterior's ``value_and_grad`` at 16 chains.  ``--only TEXT`` profiles the
calls whose names hold TEXT.
For each it prints

    wall ms/call (unprofiled), device busy ms/call (sum of the device
    kernels' times in the trace), idle share = 1 - busy / wall, and device
    ops/call (device kernels and copies in the trace)

and the profiler's table of the top device ops.  ``--out`` also writes the
whole report to FILE.  Exits non-zero where CUDA is absent.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SAMPLING_CHAINS = 64
BENCH_CHAINS = 65536
CONFIG5_CHAINS = 1024
# the config-5 ChEES arm of chip_smoke.py takes about 5 leapfrog steps per
# step on the H100 (PERF.md section 5)
CHEES_LEAPFROGS = 5


def breakdown(fn, iters, activities):
    """(wall ms/call unprofiled, device busy ms/call, device ops/call, table)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) * 1e-3 / iters
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    return wall_ms, busy_ms, len(events) / iters, table


def config5_calls(device):
    """The config-5 calls to profile, as (name, zero-argument function)."""
    from celeste_tpu_torch.bench.config5 import (
        build_config5, build_config5_multiband, build_config5_sharded,
    )
    from celeste_tpu_torch.inference import ensemble_covariance, whiten_logdensity
    from celeste_tpu_torch.inference.chees import Groups, _ensemble_step, chees_init
    from celeste_tpu_torch.inference.hmc import value_and_grad

    logd, _, vec, info = build_config5(device=device)
    rng = np.random.default_rng(0)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(CONFIG5_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    sharded = build_config5_sharded(info, None)
    rect = info["scene"].to_rect(vecs)
    # a whitened space pooled from the chains themselves: the ChEES arm's
    # step structure (whitening maps, n_leap gradients, accept) at B=1024
    logd_z, _, to_z = whiten_logdensity(logd, *ensemble_covariance(vecs, ridge=1e-4))
    state = [chees_init(to_z(vecs), logd_z)]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ensemble, h = Groups([gen], CONFIG5_CHAINS), torch.tensor(0.3)
    logd3, _, vec3, _ = build_config5_multiband(device=device)
    vecs3 = vec3[None] + torch.as_tensor(0.01 * rng.normal(size=(CONFIG5_CHAINS, vec3.shape[0])),
                                         dtype=torch.float32, device=device)

    def chees_step():
        with torch.no_grad():
            state[0] = _ensemble_step(state[0], logd_z, h, [CHEES_LEAPFROGS], ensemble)[0]

    def no_grad():
        with torch.no_grad():
            logd(vecs)

    return [
        (f"config-5 logdensity B={CONFIG5_CHAINS}", no_grad),
        (f"config-5 value_and_grad B={CONFIG5_CHAINS}", lambda: value_and_grad(logd, vecs)),
        (f"config-5 ChEES step ({CHEES_LEAPFROGS} leapfrog) B={CONFIG5_CHAINS}", chees_step),
        (f"sharded config-5 value_and_grad, one rank, B={CONFIG5_CHAINS}",
         lambda: value_and_grad(sharded["logpost"], rect)),
        (f"three-band config-5 value_and_grad B={CONFIG5_CHAINS}",
         lambda: value_and_grad(logd3, vecs3)),
    ]


PHOTOZ_TARGETS, PHOTOZ_TEMPS = 256, 6


def photoz_calls(device):
    """Config 4 at the bench batch's shape: 256 targets of ``default_rng(17)``
    (as ``bench.py``'s photo-z stage makes them), one system of 6
    temperatures each."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.inference.tempering import (
        geometric_ladder, hmc_at_beta_adaptive, pt_init, pt_kernel,
    )
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, make_photo_z_logdensity, project_to_bands,
        sdss_like_filterbank,
    )

    basis, filt = QuasarBasis.default(device), sdss_like_filterbank(n_pts=64, device=device)
    rng = np.random.default_rng(17)
    z_true = rng.uniform(0.5, 4.0, PHOTOZ_TARGETS)
    ws = rng.dirichlet(np.ones(basis.n_basis), size=PHOTOZ_TARGETS)
    flux = project_to_bands(basis, filt, torch.as_tensor(ws, dtype=torch.float32, device=device),
                            2.0, torch.as_tensor(z_true, dtype=torch.float32, device=device))
    flux = flux.cpu().numpy()
    err = 0.03 * np.abs(flux) + 1e-5
    logd = make_photo_z_logdensity(basis, filt, flux + rng.normal(size=flux.shape) * err, err,
                                   PhotoZConfig())
    d = basis.n_basis + 1
    xs = torch.as_tensor(rng.normal(size=(PHOTOZ_TARGETS, 1, PHOTOZ_TEMPS, d)),
                         dtype=torch.float32, device=device)
    betas = geometric_ladder(PHOTOZ_TEMPS, 0.02, device)
    ss = torch.full((PHOTOZ_TEMPS,), 0.05, device=device)
    im = torch.ones((PHOTOZ_TEMPS, d), device=device)
    kern = pt_kernel(logd, hmc_at_beta_adaptive(logd, ss, im, n_leapfrog=8), betas)
    state = [pt_init(xs, logd)]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def pt_step():
        with torch.no_grad():
            state[0], _ = kern(gen, state[0])

    b = PHOTOZ_TARGETS * PHOTOZ_TEMPS
    return [(f"photo-z value_and_grad {PHOTOZ_TARGETS}x{PHOTOZ_TEMPS} (B={b})",
             lambda: value_and_grad(logd, xs)),
            (f"photo-z hmc_adaptive tempered step (8 leapfrog) B={b}", pt_step)]


def config23_calls(device):
    """Configs 2 and 3 at their sampling chains (32): the five-band star
    log-density and its ``value_and_grad``, one slice batched call's
    log-density, and the galaxy's ``value_and_grad``."""
    from celeste_tpu_torch.experiments import CONFIGS, _galaxy_problem, _star_problem
    from celeste_tpu_torch.inference.hmc import value_and_grad

    out = []
    for name, problem in (("star_ugriz", _star_problem), ("galaxy", _galaxy_problem)):
        cfg = copy.deepcopy(CONFIGS[name])
        _, logd, x0 = problem(cfg, device)
        rng = np.random.default_rng(1)
        x = torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(cfg.n_chains, x0.size)))
                            .astype(np.float32), device=device)

        def no_grad(f=logd, x=x):
            with torch.no_grad():
                f(x)

        out += [(f"{name} logdensity B={cfg.n_chains}", no_grad),
                (f"{name} value_and_grad B={cfg.n_chains}",
                 lambda f=logd, x=x: value_and_grad(f, x))]
    return out


def pipeline_calls(device):
    """The stamp pipeline (the ``pipeline`` config's 33x33 field, its three
    sources as the candidates): one classify Adam step of the 2N = 6
    folded conditional rows (one K1-fwd and one K1-bwd launch), and the
    joint posterior's ``value_and_grad`` at the 16 sampling chains."""
    from celeste_tpu_torch import pipeline as tpipe
    from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.inference.map_fit import map_fit
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.parallel.crowded import CrowdedScene, make_crowded_logdensity

    cfg = CONFIGS["pipeline"]
    scene, srcs = pipeline_scene(cfg, device)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    rects = np.zeros((3, 7), np.float32)
    for i, s in enumerate(srcs):
        rects[i, :2], rects[i, 2] = scene.wcs.equa2duas(s["u"]), np.log(s["flux"][2])
        rects[i, 3:] = ([0.0, 0.0, 0.0, 0.5] if s["type"] == "star"
                        else [-0.4, np.log(s["sigma"]), 0.4, s["phi"]])
    flags = [s["type"] == "star" for s in srcs]
    cond = tpipe.Conditional(scene.stamps, [0], 1, priors)
    logd = cond.logdensity("mixed", np.repeat(np.arange(3), 2), cond.fold(rects, flags, [True] * 3),
                           is_star=[True, False] * 3)
    x = torch.as_tensor(np.repeat(rects, 2, axis=0), device=device)
    joint = CrowdedScene(kinds=tuple(s["type"] for s in srcs), n_bands=1)
    logd_joint = make_crowded_logdensity(joint, scene.stamps, bands=[0], priors=priors)
    rng = np.random.default_rng(2)
    xj = torch.as_tensor(np.concatenate([r[:3] if f else r for r, f in zip(rects, flags)])[None]
                         + 0.01 * rng.normal(size=(cfg.n_chains, joint.dim)),
                         dtype=torch.float32, device=device)

    def adam_step():
        with torch.no_grad():
            map_fit(logd, x, n_steps=1)

    return [("pipeline classify Adam step (6 folded rows)", adam_step),
            (f"pipeline joint value_and_grad B={cfg.n_chains}",
             lambda: value_and_grad(logd_joint, xj))]


def calls(device):
    """The config-1 calls to profile, as (name, zero-argument function)."""
    from celeste_tpu_torch.experiments import CONFIGS, _star_problem
    from celeste_tpu_torch.inference import hmc_init, hmc_kernel, mh_init, mh_kernel
    from celeste_tpu_torch.inference.hmc import value_and_grad

    cfg = copy.deepcopy(CONFIGS["star_single"])
    _, logd, x0 = _star_problem(cfg, device)
    kw = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)

    def chains(n):
        return torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(n, x0.size)))
                               .astype(np.float32), device=device)

    small, large = chains(SAMPLING_CHAINS), chains(BENCH_CHAINS)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    d = x0.size
    # the step size config 1's HMC warmup settles near on this scene
    hmc = hmc_kernel(logd, 0.39, torch.ones(d, **kw), n_leapfrog=cfg.n_leapfrog)
    mh = mh_kernel(logd, step_scales=torch.full((d,), 0.01, **kw))
    hmc_state = [hmc_init(small, logd)]
    mh_state = [mh_init(small, logd)]

    def hmc_step():
        with torch.no_grad():
            hmc_state[0], _ = hmc(gen, hmc_state[0])

    def mh_step():
        with torch.no_grad():
            mh_state[0], _ = mh(gen, mh_state[0])

    def no_grad(f, x):
        def call():
            with torch.no_grad():
                f(x)
        return call

    return [
        (f"logdensity B={SAMPLING_CHAINS}", no_grad(logd, small)),
        (f"value_and_grad B={SAMPLING_CHAINS}", lambda: value_and_grad(logd, small)),
        (f"logdensity B={BENCH_CHAINS}", no_grad(logd, large)),
        (f"value_and_grad B={BENCH_CHAINS}", lambda: value_and_grad(logd, large)),
        (f"HMC step ({cfg.n_leapfrog} leapfrog) B={SAMPLING_CHAINS}", hmc_step),
        (f"MH step B={SAMPLING_CHAINS}", mh_step),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="")
    ap.add_argument("--only", default="", help="profile only the calls whose names hold this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import tiled_field as tf

    mf.build_kernels()
    tf.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines = [f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"]
    tables = []
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    device = torch.device("cuda:0")
    groups = (calls, config23_calls, config5_calls, photoz_calls, pipeline_calls)
    for name, fn in (c for group in groups for c in group(device)):
        if args.only not in name:
            continue
        wall, busy, ops, table = breakdown(fn, args.iters, activities)
        if ops == 0:
            raise RuntimeError(f"chip_profile: the trace of {name!r} holds no device op")
        lines.append(f"== {name}: wall {wall:.6f} ms/call, device busy {busy:.6f} ms/call, "
                     f"idle share {1.0 - busy / wall:.4f}, device ops/call {ops:.1f}")
        tables.append(f"== {name}\n{table}")
    report = "\n".join(lines)
    print(report, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report + "\n\n" + "\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
