#!/usr/bin/env python3
"""Where the device time of config 1 (``star_single``), configs 2 and 3
(``star_ugriz``, ``galaxy``) and config 5 (the crowded field) goes, on one
NVIDIA GPU.

    python3 chip_profile.py [--iters N] [--out FILE]

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
B=1024.  For each it prints

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
    from celeste_tpu_torch.inference.chees import _ensemble_step, chees_init
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
    logd3, _, vec3, _ = build_config5_multiband(device=device)
    vecs3 = vec3[None] + torch.as_tensor(0.01 * rng.normal(size=(CONFIG5_CHAINS, vec3.shape[0])),
                                         dtype=torch.float32, device=device)

    def chees_step():
        with torch.no_grad():
            state[0] = _ensemble_step(gen, state[0], logd_z, 0.3, CHEES_LEAPFROGS)[0]

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
    for name, fn in calls(device) + config23_calls(device) + config5_calls(device):
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
