#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``celeste_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no caught exception):

1. require CUDA and print the card's name and power limit;
2. build the CUDA libraries of ``celeste_tpu_torch/csrc`` with nvcc (sm_90a),
   one nvcc per source, all started together;
3. hold the stamp kernels (K1-fwd, K1-bwd) against their plain PyTorch
   versions: star (C=3) and galaxy (C=48) planes at B=1, 9, 32, 64, 1000
   and 4096 (every launch geometry the wrapper picks) and the star at
   B=65536, on 25x25 stamps and on 96x96 and 128x128 ones (9216 and 16384
   pixels; the backward there at B <= 64), centered both ways, full
   and holed masks; values rtol 2e-6, atol 0.5 (galaxies 1.0), gradients
   against the plain backward rtol 5e-4, atol 5e-2, finite for a
   zero-amplitude component; each kernel called twice, bitwise equal;
4. hold the tiled kernels (K2, K3, K4) against theirs on config-5 planes at
   B=1000 and 4096, centered both ways, full and holed masks: K2 and K3's
   log-likelihood rtol 2e-6, atol 1.0; K3's lambda rtol 1e-5, atol 1e-3; K4
   against torch autograd through the plain forward, rtol 5e-4, atol 0.1;
   K4 on the random-plane setup with repeated sentinel slots, rtol 2e-4,
   atol 5e-3; K4 twice on the same inputs, bitwise equal; a table of
   sentinels only adds exactly 0 with finite gradients; then the render
   kernels (K5, K6) on config-5 planes in the rectangular layout with the
   one-rank tables, B=1000 and 4096, per bucket: K5's lambda rtol 1e-5,
   atol 1e-3; K6 against its plain version and against torch autograd
   through the plain K5, rtol 5e-4, atol 0.1; K6 on the random-plane setup,
   rtol 2e-4, atol 5e-3; K6 twice, bitwise equal; sentinels render exactly
   0 with finite cotangents;
5. hold the stamp render kernel (K7) against its plain version on star
   (C=3, 25x25) and galaxy (C=48, 31x31) planes at B=32, 1000 and 4096, on
   config 5's dense planes over the 48x128 field at B=1024, and on random
   problems (``random_render_problem``) at every geometry ``k7_geometry``
   picks (B = 1, 9, 32, 64, 1000, 4096), C = 3, 48, 126, on 25x25, 31x31,
   48x128 and 128x128 pixel sets, rtol 1e-5, atol 1e-3, zero-amplitude
   rows exactly the sky, two calls bitwise equal; the separable kernels
   (K8-fwd, K8-bwd) against theirs and K8-fwd against K1 on the same
   isotropic star planes, B=1000 and 4096, and on random problems
   (``random_sep_problem``) at W = 25, 31, 32, 33, 64, 100 with H != W,
   C = 1, 3, 4, 5 and B = 1, 7, 4096 (and B=65536 at three of them),
   centered both ways, full and holed masks, values rtol 2e-6, atol 0.5,
   cotangents against the plain backward and torch autograd rtol 5e-4,
   atol 5e-2, finite for zero-amplitude components, two calls bitwise
   equal;
6. the card's log-likelihood at the truth against the fp64 NumPy oracle,
   for config 1 (25x25 stamp), config 2 (each of the five bands), config 3
   (31x31 galaxy) and config 5 (tiled, 48x128 field), and the config-5
   tiled-vs-dense parity gate (gap < 1 nat; a 0.05 radii cut trips it above
   100); config 5's dense reference takes its ``value_and_grad`` at B=64
   on the card (one K1-bwd launch over 6144 pixels and 126 components), its
   likelihood cotangents held against the plain backward at rtol 5e-4,
   atol 5e-2;
7. drive config 1 through its entry point, ``run_experiment`` of
   ``star_single`` (64 chains), MH as written and HMC, with the stamp
   kernels' counters set to 0 just before and read just after; fail on
   max R-hat > 1.1, on a truth outside mean +- 5 std, or on a kernel the
   run never launched;
8. drive config 5 at full width (12 sources, 48x128, 1024 chains) with every
   counter set to 0 just before and read just after: ``build_config5`` ->
   parity -> ``config5_warmup_and_whiten`` -> ``measure_chees_z`` ->
   ``measure_nuts_z``, then ``run_experiment`` of ``crowded_field`` with
   ``tiled=true n_galaxies=2``; gates: finite samples, ChEES accept >= 0.4,
   divergence <= 0.05 in both arms, max split-R-hat <= 1.1 on the ChEES
   arm; check the whitening maps on the card against float64 on the host;
   fail on a tiled kernel the run never launched;
9. drive config 5 in three bands (g, r, i) at full width (12 sources,
   48x128, 1024 chains) with every counter set to 0 just before and read
   just after: ``build_config5_multiband`` -> the parity gate (gap < 1 nat;
   a 0.05 radii cut trips it above 100) -> each band's tiled ll at the
   truth against the fp64 oracle -> the committed three-band artifacts'
   saved logps against a live evaluation (printed, not gated) -> one
   gradient's launches (K3 and K4 once per band and bucket) ->
   ``config5_warmup_and_whiten`` -> ``measure_chees_z``, cut in steps by
   MULTIBAND_PREP and MULTIBAND_CHEES; gates: finite samples, accept >=
   0.4, divergence <= 0.05, max split-R-hat printed; fail on a tiled kernel
   the run never launched;
10. drive configs 2 and 3 through ``run_experiment``, the stamp kernels'
   counters set to 0 just before each run and read just after: ``star_ugriz``
   (32 chains, five 25x25 bands) with HMC (max R-hat <= 1.1) and with the
   slice sampler (<= 1.15), the truth within mean +- 5 std, slice against
   HMC means within 0.5 sigma and widths within (0.65, 1.55); ``galaxy``
   (32 chains, 31x31) with NUTS, divergence < 0.05, R-hat < 1.2, the truth
   within 5 std (phi in principal value); K1 launched by each.  Then the
   posterior-predictive check on config 2's r band and on config 3 (K7's
   counter set to 0 just before): p in (0.02, 0.98), and p < 0.02 with the
   source's log-flux at -8.  Then ``batched_stamp_loglik(impl="sep")`` and
   its gradient at B=65536 on config 1's stamp (K8's counters set to 0
   just before), against the general kernel;
11. drive the source-sharded config 5 at full width (12 sources, 48x128,
   1024 chains, per-source radii), every tiled counter set to 0 just
   before and read just after: on a one-rank NCCL mesh (1, 1), in this
   process, the sharded tiled log-likelihood plus the rectangular prior
   against the single-device tiled posterior of the same radii (values
   rtol 2e-6, atol 1.0; gradients through ``from_rect`` rtol 5e-4, atol
   0.1; the padding's likelihood gradient exactly 0) and against the dense
   reference (gap < 1 nat); then ``run_sharded_chees`` on the rectangular
   posterior (D = 84), gates finite samples, accept >= 0.4, divergence <=
   0.05; fail if K5 or K6 was never launched.  Then two spawned gloo ranks
   on this one card, mesh (1, 2), must give the one-rank value and gradient
   at the same tolerances, and ``dryrun_multichip(1)`` runs;
12. time with CUDA events (best of 3 after a warm-up), in ms per wrapper
   call: config 1 at B=65536 (K1 and the HMC gradient, kernel and plain);
   K2, K3 and K4 over config 5's field at B=1024 and 4096 (both buckets'
   launches timed together, divided by two), and one config-5
   ``value_and_grad`` at B=1024, one band and three, kernel and plain; K5 and K6 over the sharded tables at B=1024
   and 4096, kernel and plain, and one sharded ``value_and_grad`` at B=1024
   beside the single-device one; K8-fwd and K8-bwd at B=65536 on config 1's
   stamp in turns with K1-fwd and K1-bwd (device time from CUDA graphs of
   20 calls), plain, and the entry point's ``value_and_grad`` with each
   kernel; K7 at B=1024 on config 5's field and on a 25x25 stamp, kernel
   and plain, and at the PPC's two launch shapes (32 draws: config 2's
   star, C=3, 640 pixels; config 3's galaxy, C=48, 1024) from CUDA graphs,
   with bound, launches and loss; K1-fwd and K1-bwd at each shape
   where the paths call them (config 1 at 64 chains, config 2's bands and
   config 3 at 32, config 5's dense probe at 8, config 1's stamp at 65536),
   device time per call from a CUDA graph of 20 calls, with the bound and
   this run's launches at that shape;
13. print K1's rows by shape as a JSON line (``k1_shapes``, with the time
    lost, launches x (ms - bound), summed per kernel in ``k1_lost_s``), K7's
    likewise (``k7_shapes``, ``k7_lost_s``), then the kernels' JSON line
    (K1-fwd, K1-bwd, K2-K7, K8-fwd, K8-bwd), each kernel's ms per wrapper
    call (K2-K4: both buckets timed together, divided by their two
    launches; their launches those of both config-5 paths, one band and
    three) with its bound per call (the largest of its bytes over the
    card's memory rate, its float32 operations over the card's float32
    rate, and its exponentials and logarithms over the special-function
    unit's rate), failing on a kernel faster than its
    bound, then the card line and the result line.

Before its last lines, and on any failure, the script stops every process
it started that still runs (the resource tracker that the spawned ranks'
queues start, and any other child).

Config 5's one-band flow runs the bench's step counts (the defaults of
``celeste_tpu_torch/bench/config5.py``) but for its NUTS arm.  That arm,
the three-band flow, the entry-point runs and the sharded ChEES run are
cut in steps only so that the script fits its time, by the constants
below (PERF.md lists them).
"""

from __future__ import annotations

import copy
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

FWD_TOL = {"star": (2e-6, 0.5), "galaxy": (2e-6, 1.0)}   # (rtol, atol)
BWD_TOL = (5e-4, 5e-2)
ORACLE_TOL = (2e-6, 1.0)
TILED_TOL = (2e-6, 1.0)
TILED_BWD_TOL = (5e-4, 0.1)
RANDOM_BWD_TOL = (2e-4, 5e-3)
LAM_TOL = (1e-5, 1e-3)
BENCH_CHAINS = 65536
C5_CHAINS = 1024
TIMING_CHAINS = (1024, 4096)   # the config-5 kernel timings
# the entry point's crowded_field run (defaults: 300 warmup, 500 steps, 16 leapfrog)
ENTRY_CROWDED = dict(n_warmup=32, n_steps=32, n_leapfrog=8)
# config 5's NUTS arm (the JAX bench: 64 steps in segments of 16)
C5_NUTS = dict(n_steps=32, run_segment=16)
# config 5 in three bands (g, r, i), cut in steps only (chains, bands,
# sources and field as the JAX bench has them), against the JAX bench's
# stage (bench.py _bench_config5_multiband): HMC warmup 150 in windows of 50
# from a step of 0.03, NUTS probe 16, z-space warmup 30; ChEES warmup 60 in
# windows of 20, 192 steps in segments of 48
MULTIBAND_PREP = dict(n_warmup=50, warmup_window=50, init_step_size=0.03, probe_steps=4,
                      n_zwarm=10)
MULTIBAND_CHEES = dict(warmup_iters=20, warmup_window=20, n_steps=48, run_segment=48)
MULTIBAND_ARTIFACTS = ("config5_multiband_prep", "config5_multiband_chees_prep")
# config 1's HMC run (the config: 300 warmup, 500 steps)
STAR_HMC = dict(n_steps=250, n_warmup=300)
# the sharded ChEES run on config 5's rectangular posterior (the JAX
# helper's defaults: 100 warmup, 400 steps, trajectory cap 256)
SHARDED_CHEES = dict(n_warmup=100, n_steps=100, max_leapfrog=32)
# configs 2 and 3 through the entry point, cut in steps only (chains, bands
# and stamps as the configs have them): star_ugriz HMC (JAX defaults: 300
# warmup, 1000 steps) and slice (1000 sweeps); galaxy NUTS (300 warmup, 800
# steps)
UGRIZ_HMC = dict(n_warmup=300, n_steps=150)
UGRIZ_SLICE = dict(n_steps=100)
GALAXY_NUTS = dict(n_warmup=150, n_steps=150)
SEP_TOL = (2e-6, 0.5)           # K8 against its plain version and against K1
# phase 5: K8 on random problems at widths below, at and above a warp's 32
# columns and over several column blocks (H != W), C on both sides of the
# C <= 4 template, B = 1, 7 and 4096 at each, and B = 65536 at three
SEP_GRID = tuple((b, c, h, w) for w, h in ((25, 21), (31, 26), (32, 27), (33, 40), (64, 57),
                                           (100, 90))
                 for c in (1, 3, 4, 5) for b in (1, 7, 4096)) + (
    (65536, 3, 25, 25), (65536, 1, 40, 33), (65536, 5, 40, 33))
# phase 3: K1 at every geometry k1_geometry picks, on config 1's 25x25 stamp
# size and on 96x96 and 128x128 stamps (the backward there at B <= 64)
K1_CHAINS = (1, 9, 32, 64, 1000, 4096)
K1_SIDES = (25, 96, 128)
K1_BWD_MAX_CHAINS = 64
# phase 5: K7 at every geometry k7_geometry picks, for a star's, a galaxy's
# and config 5's component counts, on 25x25, 31x31, 48x128 and 128x128
K7_CHAINS = (1, 9, 32, 64, 1000, 4096)
K7_COMPONENTS = (3, 48, 126)
K7_SHAPES = ((25, 25), (31, 31), (48, 128), (128, 128))
DENSE_CHAINS = 64               # phase 6: config 5's dense gradient
PPC_DRAWS = 32
# the card's peaks (H100 SXM at 700 W, NVIDIA's data sheet: HBM3 rate, float32
# outside the tensor cores; 67 TFLOP/s is 132 SMs x 128 lanes x 2 x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# exponentials and logarithms go through the special-function unit: 16 per
# clock per SM (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0: base-2 exponential and logarithm) on
# 132 SMs at the 1.98 GHz behind the float32 peak
SPECIAL_PER_S = 132 * 16 * 1.98e9
# float32 operations the kernels' algebra needs, a multiply-add counted as
# two as the peak counts it, exponentials and logarithms counted apart.  Per
# (pixel, component) term: the offsets dx, dy and the base-2 quadratic form
# (qa dx + qb dy) dx + qc dy dy, 9; lambda's a * e summed, 2; the backward's
# six pixel moments of ge = g_lam e (ge, its sum, ge dx and ge dy and their
# sums, three multiply-adds for ge dx^2, ge dx dy, ge dy^2), 12, the
# algebra of every backward here (K1-bwd, K4, K6: the moment form).  Per entry
# and chain, the moment form's epilogue (-a/2, three second-moment products,
# pa Sx + pb Sy and pb Sx + pc Sy and their products by a), 12.  Per pixel,
# the Poisson term (clamp, multiply, subtract, mask) 4 and its cotangent
# g_lam 6.
FLOPS_TERM_FORM, FLOPS_TERM_SUM, FLOPS_TERM_MOMENTS = 9, 2, 12
FLOPS_ENTRY_EPILOGUE = 12
FLOPS_PIXEL_LOGLIK, FLOPS_PIXEL_GLAM = 4, 6
# the separable kernel (K8): a row or column factor of a component takes the
# offset, its square, the products by the inverse variance and by -1/2 and
# (rows) the amplitude, 5, and an exponential; a pixel then adds each
# component's col * row in one multiply-add, 2 per component; the backward's
# two contractions are a multiply-add per (pixel, component) each, 4, and
# each factor's cotangent sums take 6 more
FLOPS_SEP_FACTOR, FLOPS_SEP_TERM, FLOPS_SEP_CONTRACT, FLOPS_SEP_FACTOR_COT = 5, 2, 4, 6


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def max_abs_err(got, want, rtol, atol, what):
    """max |got - want|, after checking |got - want| <= atol + rtol |want|."""
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} values outside rtol={rtol} atol={atol}, "
          f"max abs err {float(err.max()):.4g}")
    return float(err.max())


def time_ms(fn, reps):
    """Best of 3 trials of ``reps`` calls after one warm-up call, ms per call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def child_processes():
    """(pid, command line) of every child of this process, from /proc."""
    me, out = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]   # after "(comm) state"
            if ppid == me:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    out.append((int(pid), f.read().replace(b"\0", b" ").decode().strip()))
        except (OSError, IndexError):
            pass                                  # it ended while we looked
    return out


def stop_children():
    """Stop every process this script started that still runs.  The spawned
    gloo ranks' queues start multiprocessing's resource tracker, which lives
    until its parent ends; it is closed here, and any other child is sent
    SIGTERM (SIGKILL after 10 s) and reaped, with a line saying so."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    left = child_processes()
    for pid, cmd in left:
        print(f"[exit] stopping child process {pid}: {cmd}", file=sys.stderr, flush=True)
        os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 10.0
    for pid, _ in left:
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except ChildProcessError:
            pass                                  # already reaped


# ---------------------------------------------------------------------------
# config 1: the stamp kernels
# ---------------------------------------------------------------------------

def stamp_scene(kind, side, device):
    """Phase 3's one-source r-band scene: a star (seed 3) or a galaxy (seed 5)
    on a side x side stamp."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    src = (star_source(u=(30.0001, 9.9999), flux_r=25.0) if kind == "star"
           else galaxy_source(u=(30.0, 10.0), flux_r=60.0))
    return make_synthetic_stamp([src], shape=(side, side), bands=(2,),
                                seed=3 if kind == "star" else 5, device=device)


def source_vecs(scene, kind, n, seed):
    """[n, D] unconstrained vectors scattered around the truth (5 bands)."""
    src = scene.sources[0]
    base = [scene.wcs.equa2duas(src["u"]), np.log(src["flux"])]
    if kind == "galaxy":
        t, ab = src["theta_dev"], src["ab"]
        base.append([np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)),
                     src["phi"]])
    base = np.concatenate(base)
    rng = np.random.default_rng(seed)
    return (base[None, :] + 0.05 * rng.normal(size=(n, base.size))).astype(np.float32)


def plain_fwd(planes, pix, centered, chunk=256):
    """K1's plain forward a chain chunk at a time (a 128x128 galaxy at
    B=4096 is 13 GB per [B, C, P] intermediate unchunked)."""
    from celeste_tpu_torch.kernels import mog_field as mf

    return torch.cat([mf._loglik_torch(*(p[c0:c0 + chunk] for p in planes), *pix,
                                       centered=centered)
                      for c0 in range(0, planes[0].shape[0], chunk)])


def stamp_kernel_checks(device):
    """Phase 3: K1-fwd and K1-bwd against their plain versions at every
    geometry the chooser picks and on 96x96 and 128x128 stamps,
    each kernel twice on the same inputs, bitwise equal."""
    from celeste_tpu_torch.kernels import mog_field as mf

    errs = {"fwd": 0.0, "bwd": 0.0}
    for kind in ("star", "galaxy"):
        rtol, atol = FWD_TOL[kind]
        for side in K1_SIDES:
            scene = stamp_scene(kind, side, device)
            stamp = scene.stamps[0]
            pd = mf.stamp_pixel_data(stamp)
            holed = pd[4].clone()
            holed[0, ::7] = 0.0
            masks = {"full": pd[4], "holed": holed}
            chains = K1_CHAINS + ((BENCH_CHAINS,) if (kind, side) == ("star", 25) else ())
            for b in chains:
                vecs = torch.as_tensor(source_vecs(scene, kind, b, seed=b), device=device)
                planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 2, kind, 5)]
                tag = f"{kind} {side}x{side} B={b} (CB, T)={mf.k1_geometry(b, pd[0].shape[1])}"
                for mname, mask in masks.items():
                    pix = (*pd[:4], mask)
                    for centered in (False, True):
                        got = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
                        again = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
                        want = plain_fwd(planes, pix, centered)
                        torch.cuda.synchronize()
                        what = f"K1-fwd {tag} mask={mname} centered={centered}"
                        check(torch.equal(got, again), f"{what}: two calls differ")
                        errs["fwd"] = max(errs["fwd"], max_abs_err(got, want, rtol, atol, what))
                if side != 25 and b > K1_BWD_MAX_CHAINS:
                    continue
                g = torch.as_tensor(np.random.default_rng(b + 1).normal(size=b)
                                    .astype(np.float32), device=device)
                zero_amp = planes[0].clone()
                zero_amp[::5, 0] = 0.0
                for aname, amp in (("amp", planes[0]), ("zero-amp", zero_amp)):
                    ps = [amp, *planes[1:]]
                    pix = (*pd[:4], holed)
                    got = mf.loglik_bwd_cuda(*ps, *pix, g)
                    again = mf.loglik_bwd_cuda(*ps, *pix, g)
                    want = mf._loglik_bwd_torch(*ps, *pix, g)
                    torch.cuda.synchronize()
                    for name, a, a2, w in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, again,
                                              want):
                        what = f"K1-bwd {tag} {aname} d_{name}"
                        check(torch.equal(a, a2), f"{what}: two calls differ")
                        errs["bwd"] = max(errs["bwd"], max_abs_err(a, w, *BWD_TOL, what))
            print(f"[kernels] K1 {kind} {side}x{side}: forward at B={chains}, backward at "
                  f"B<={chains[-1] if side == 25 else K1_BWD_MAX_CHAINS} match the plain "
                  f"versions; repeats bitwise equal", flush=True)
    return errs


# ---------------------------------------------------------------------------
# config 5: the tiled kernels
# ---------------------------------------------------------------------------

def c5_planes(config5, n, seed):
    """Config-5 block planes of ``n`` chains scattered around the truth."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    _, _, vec, info = config5
    rng = np.random.default_rng(seed)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(n, vec.shape[0])),
                                       dtype=torch.float32, device=vec.device)
    return [p.contiguous() for p in tf.scene_planes_blocked(info["scene"], vecs, info["stamp"], 0)]


def autograd_plain(planes, tile_src, pixels, g, chunk=128):
    """Torch autograd through the plain tiled forward, a chain chunk at a time."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    out = []
    for c0 in range(0, planes[0].shape[0], chunk):
        leaves = [p[c0:c0 + chunk].detach().clone().requires_grad_(True) for p in planes]
        ll = tf._tiled_torch(leaves, tile_src, pixels, 3)
        out.append(torch.autograd.grad(ll, leaves, g[c0:c0 + chunk]))
    return [torch.cat(d) for d in zip(*out)]


def random_tile_problem(device, seed, b):
    """The tiled module's random problem on the card: planes (zero sentinel
    slot last), the table on the card and as NumPy, pixel tiles and g [b]."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    planes, tile_src, pixels, g = tf.random_tile_problem(seed=seed, b=b)
    return ([torch.as_tensor(p, device=device) for p in planes],
            torch.as_tensor(tile_src, device=device), tile_src,
            [torch.as_tensor(p, device=device) for p in pixels], torch.as_tensor(g, device=device))


def tiled_kernel_checks(device, config5):
    """Phase 4: K2, K3 and K4 against their plain versions."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0, "K4 random": 0.0}
    buckets = config5[3]["tiled_data"].bucket_tables
    for b in (1000, 4096):
        planes = c5_planes(config5, b, seed=b)
        g = torch.as_tensor(np.random.default_rng(b + 1).normal(size=b).astype(np.float32),
                            device=device)
        for i, bk in enumerate(buckets):
            holed = bk.pixels[4].clone()
            holed[:, ::7] = 0.0
            for mname, mask in (("full", bk.pixels[4]), ("holed", holed)):
                pix = (*bk.pixels[:4], mask)
                for centered in (False, True):
                    what = f"B={b} bucket={i} mask={mname} centered={centered}"
                    want, want_lam = tf._tiled_lam_torch(planes, bk.tile_src, pix, 3, centered)
                    got = tf.tiled_fwd_cuda(*planes, bk.tile_src, *pix, n_comp=3,
                                            centered=centered)
                    ll, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *pix, n_comp=3,
                                                    centered=centered)
                    torch.cuda.synchronize()
                    errs["K2"] = max(errs["K2"], max_abs_err(got, want, *TILED_TOL, "K2 " + what))
                    errs["K3"] = max(errs["K3"], max_abs_err(ll, want, *TILED_TOL, "K3 " + what))
                    max_abs_err(lam, want_lam, *LAM_TOL, "K3 lambda " + what)
            _, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
            cols = bk.columns(3, planes[0].shape[1])
            got = tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols, n_comp=3)
            again = tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols, n_comp=3)
            want = autograd_plain(planes, bk.tile_src, bk.pixels, g)
            torch.cuda.synchronize()
            for name, a, w, a2 in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, want, again):
                errs["K4"] = max(errs["K4"], max_abs_err(a, w, *TILED_BWD_TOL,
                                                         f"K4 B={b} bucket={i} d_{name}"))
                check(torch.equal(a, a2), f"K4 B={b} bucket={i} d_{name}: two calls differ")
    for b in (37, 1000):
        planes, ts, ts_np, pix, g = random_tile_problem(device, seed=b, b=b)
        want_ll, want_lam = tf._tiled_lam_torch(planes, ts, pix, 3)
        ll, lam = tf.tiled_fwd_lam_cuda(*planes, ts, *pix, n_comp=3)
        cols = [torch.as_tensor(c, device=device) for c in tf.tile_columns(ts_np, 3, 15)]
        got = tf.tiled_bwd_cuda(*planes, ts, *pix, lam, g, *cols, n_comp=3)
        again = tf.tiled_bwd_cuda(*planes, ts, *pix, lam, g, *cols, n_comp=3)
        hand = tf._tiled_bwd_torch(planes, ts, pix, want_lam, g, 3)
        auto = autograd_plain(planes, ts, pix, g)
        torch.cuda.synchronize()
        max_abs_err(ll, want_ll, 2e-5, 2e-2, f"K3 random B={b}")
        for name, a, h, w, a2 in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, hand, auto,
                                     again):
            max_abs_err(a, h, *RANDOM_BWD_TOL, f"K4 random B={b} d_{name} vs plain K4")
            errs["K4 random"] = max(errs["K4 random"], max_abs_err(
                a, w, *RANDOM_BWD_TOL, f"K4 random B={b} d_{name} vs autograd"))
            check(torch.equal(a, a2), f"K4 random B={b} d_{name}: two calls differ")
        only_sentinel = torch.full_like(ts, 4)
        _, lam = tf.tiled_fwd_lam_cuda(*planes, only_sentinel, *pix, n_comp=3)
        check(torch.equal(lam, pix[3][:, None, :].expand_as(lam)), "sentinel slots add to lambda")
        cols = [torch.as_tensor(c, device=device)
                for c in tf.tile_columns(only_sentinel.cpu().numpy(), 3, 15)]
        grads = tf.tiled_bwd_cuda(*planes, only_sentinel, *pix, lam, g, *cols, n_comp=3)
        check(all(bool(torch.isfinite(d).all()) for d in grads), "sentinel gradients not finite")
    print(f"[kernels] K2, K3, K4 match the plain versions (max abs err {errs}); "
          f"K4 is bitwise deterministic", flush=True)
    return errs


def rect_states(sharded5, n, seed):
    """``n`` rectangular config-5 states [n, 12, 7] scattered around the
    truth (the star padding stays 0)."""
    from celeste_tpu_torch.parallel.crowded import STAR_D

    rect = sharded5["rect"]
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(0.01 * rng.normal(size=(n,) + tuple(rect.shape)),
                            dtype=torch.float32, device=rect.device)
    scene = sharded5["scene"]
    for i, kind in enumerate(scene.kinds):
        if kind == "star":
            noise[:, i, STAR_D(scene.n_bands):] = 0.0
    return rect[None] + noise


def render_kernel_checks(device, sharded5):
    """Phase 4, second part: K5 and K6 against their plain versions."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    errs = {"K5": 0.0, "K6": 0.0, "K6 random": 0.0}
    loglik = sharded5["loglik"]
    for b in (1000, 4096):
        planes = [p.contiguous() for p in loglik.planes(rect_states(sharded5, b, seed=b))]
        for i, bk in enumerate(loglik.buckets):
            what = f"B={b} bucket={i}"
            lam = tf.tiled_render_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
            want = tf._tiled_render_torch(planes, bk.tile_src, *bk.pixels, 3)
            g = torch.as_tensor(np.random.default_rng(b + i).normal(size=tuple(lam.shape))
                                .astype(np.float32), device=device)
            cols = bk.columns(3, planes[0].shape[1])
            got = tf.tiled_render_bwd_cuda(*planes, bk.tile_src, *bk.pixels, g, *cols, n_comp=3)
            again = tf.tiled_render_bwd_cuda(*planes, bk.tile_src, *bk.pixels, g, *cols,
                                             n_comp=3)
            hand = tf._tiled_render_bwd_torch(planes, bk.tile_src, *bk.pixels, g, 3)
            auto = autograd_render(planes, bk, g)
            torch.cuda.synchronize()
            errs["K5"] = max(errs["K5"], max_abs_err(lam, want, *LAM_TOL, "K5 " + what))
            for name, a, h, w, a2 in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, hand, auto,
                                         again):
                max_abs_err(a, h, *TILED_BWD_TOL, f"K6 {what} d_{name} vs plain K6")
                errs["K6"] = max(errs["K6"], max_abs_err(a, w, *TILED_BWD_TOL,
                                                         f"K6 {what} d_{name} vs autograd"))
                check(torch.equal(a, a2), f"K6 {what} d_{name}: two calls differ")
    for b in (37, 1000):
        planes, ts, ts_np, pix, _ = random_tile_problem(device, seed=b, b=b)
        px, py = pix[:2]
        g = torch.as_tensor(np.random.default_rng(b).normal(size=(3, b, 1024))
                            .astype(np.float32), device=device)
        lam = tf.tiled_render_cuda(*planes, ts, px, py, n_comp=3)
        cols = [torch.as_tensor(c, device=device) for c in tf.tile_columns(ts_np, 3, 15)]
        got = tf.tiled_render_bwd_cuda(*planes, ts, px, py, g, *cols, n_comp=3)
        again = tf.tiled_render_bwd_cuda(*planes, ts, px, py, g, *cols, n_comp=3)
        want = tf._tiled_render_bwd_torch(planes, ts, px, py, g, 3)
        torch.cuda.synchronize()
        max_abs_err(lam, tf._tiled_render_torch(planes, ts, px, py, 3), *LAM_TOL,
                    f"K5 random B={b}")
        for name, a, w, a2 in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, want, again):
            errs["K6 random"] = max(errs["K6 random"], max_abs_err(
                a, w, *RANDOM_BWD_TOL, f"K6 random B={b} d_{name}"))
            check(torch.equal(a, a2), f"K6 random B={b} d_{name}: two calls differ")
        only_sentinel = torch.full_like(ts, 4)
        lam = tf.tiled_render_cuda(*planes, only_sentinel, px, py, n_comp=3)
        check(bool((lam == 0).all()), "sentinel slots render a non-zero lambda")
        cols = [torch.as_tensor(c, device=device)
                for c in tf.tile_columns(only_sentinel.cpu().numpy(), 3, 15)]
        grads = tf.tiled_render_bwd_cuda(*planes, only_sentinel, px, py, g, *cols, n_comp=3)
        check(all(bool(torch.isfinite(d).all()) for d in grads), "sentinel cotangents not finite")
    print(f"[kernels] K5, K6 match the plain versions (max abs err {errs}); K6 is bitwise "
          f"deterministic", flush=True)
    return errs


def autograd_render(planes, bucket, g, chunk=128):
    """Torch autograd through the plain K5, a chain chunk at a time."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    out = []
    for c0 in range(0, planes[0].shape[0], chunk):
        leaves = [p[c0:c0 + chunk].detach().clone().requires_grad_(True) for p in planes]
        lam = tf._tiled_render_torch(leaves, bucket.tile_src, *bucket.pixels, 3)
        out.append(torch.autograd.grad(lam, leaves, g[:, c0:c0 + chunk]))
    return [torch.cat(d) for d in zip(*out)]


# ---------------------------------------------------------------------------
# configs 2 and 3: the stamp render kernel and the separable kernels
# ---------------------------------------------------------------------------

def ugriz_scene(device):
    """star_ugriz's scene: one star in five 25x25 bands, seed 0."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source

    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    return make_synthetic_stamp([src], shape=(25, 25), bands=(0, 1, 2, 3, 4), seed=0,
                                device=device)


def galaxy_scene(device):
    """galaxy's scene: one galaxy on a 31x31 r-band stamp, seed 0."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp

    return make_synthetic_stamp([galaxy_source(u=(30.0, 10.0), flux_r=60.0)], shape=(31, 31),
                                bands=(2,), seed=0, device=device)


def stamp_render_checks(device, config5):
    """K7 against its plain version: star (C=3, 25x25) and galaxy (C=48,
    31x31) planes at B=32 (the PPC's draws), 1000 and 4096, with every 9th
    row at zero amplitude (it must render exactly the sky); config 5's
    dense planes (C=126) over the 48x128 field at B=1024; and
    ``random_render_problem`` at every geometry ``k7_geometry`` picks
    (K7_CHAINS), C in K7_COMPONENTS, on the K7_SHAPES pixel sets, each call
    twice, bitwise equal."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    err = 0.0
    for b in K7_CHAINS:
        for c in K7_COMPONENTS:
            for h, w in K7_SHAPES:
                planes, (px, py, sky) = (
                    [torch.as_tensor(a, device=device) for a in arrays]
                    for arrays in mf.random_render_problem(b, c, h, w, seed=b + c + w))
                what = f"K7 random B={b} C={c} {h}x{w} (CB, T)={mf.k7_geometry(b, px.shape[1])}"
                got = mf.render_cuda(*planes, px, py, sky)
                again = mf.render_cuda(*planes, px, py, sky)
                want = mf._render_torch(*planes, px, py, sky)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{what}: two calls differ")
                err = max(err, max_abs_err(got, want, *LAM_TOL, what))
                check(torch.equal(got[::9], sky.expand(got[::9].shape[0], -1)),
                      f"{what}: a zero-amplitude row does not render exactly the sky")
    for kind, scene in (("star", stamp_scene("star", 25, device)),
                        ("galaxy", galaxy_scene(device))):
        stamp = scene.stamps[0]
        px, py, _, sky, _ = mf.stamp_pixel_data(stamp)
        for b in (32, 1000, 4096):
            vecs = torch.as_tensor(source_vecs(scene, kind, b, seed=b), device=device)
            planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 2, kind, 5)]
            planes[0][::9] = 0.0
            got = mf.render_cuda(*planes, px, py, sky)
            want = mf._render_torch(*planes, px, py, sky)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want, *LAM_TOL, f"K7 {kind} B={b}"))
            check(torch.equal(got[::9], sky.expand(got[::9].shape[0], -1)),
                  f"K7 {kind} B={b}: a zero-amplitude row does not render exactly the sky")
    _, _, vec, info = config5
    rng = np.random.default_rng(5)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(C5_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    planes = [p.contiguous() for p in scene_field_planes(info["scene"], vecs, info["stamp"], 0)]
    px, py, _, sky, _ = mf.stamp_pixel_data(info["stamp"])
    got = mf.render_cuda(*planes, px, py, sky)
    want = mf._render_torch(*planes, px, py, sky)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(got, want, *LAM_TOL, f"K7 config-5 field B={C5_CHAINS}"))
    print(f"[kernels] K7 matches the plain version on star, galaxy and config-5 planes and on "
          f"random problems at B={K7_CHAINS}, C={K7_COMPONENTS}, pixel sets {K7_SHAPES} (max abs "
          f"err {err:.4g}); zero-amplitude rows render exactly the sky; repeats bitwise equal",
          flush=True)
    return err


def sep_kernel_checks(device):
    """K8-fwd against its plain version and against K1 on the same isotropic
    star planes; K8-bwd against its plain version and torch autograd through
    the plain forward, finite for zero-amplitude components, bitwise equal
    across two calls."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    errs = {"fwd": 0.0, "bwd": 0.0}
    scene = stamp_scene("star", 25, device)
    stamp = scene.stamps[0]
    pd2 = ms.stamp_pixel_data_2d(stamp)
    pd1 = mf.stamp_pixel_data(stamp)
    holed2 = pd2[4].clone()
    holed2[:, ::7] = 0.0
    holed1 = pd1[4].clone()
    holed1[0, :holed2.numel()] = holed2.reshape(-1)
    masks = {"full": (pd2[4], pd1[4]), "holed": (holed2, holed1)}
    for b in (1000, 4096):
        vecs = torch.as_tensor(source_vecs(scene, "star", b, seed=b), device=device)
        planes = [t.contiguous() for t in ms.star_planes_isotropic(vecs, stamp, 2, 5)]
        k1_planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 2, "star", 5)]
        for mname, (m2, m1) in masks.items():
            for centered in (False, True):
                what = f"B={b} mask={mname} centered={centered}"
                got = ms.sep_fwd_cuda(*planes, *pd2[:4], m2, centered=centered)
                want = ms._sep_loglik_torch(*planes, *pd2[:4], m2, centered=centered)
                k1 = mf.loglik_fwd_cuda(*k1_planes, *pd1[:4], m1, centered=centered)
                torch.cuda.synchronize()
                errs["fwd"] = max(errs["fwd"], max_abs_err(got, want, *SEP_TOL, "K8-fwd " + what))
                max_abs_err(got, k1, *SEP_TOL, "K8-fwd vs K1-fwd " + what)
        g = torch.as_tensor(np.random.default_rng(b + 1).normal(size=b).astype(np.float32),
                            device=device)
        zero_amp = planes[0].clone()
        zero_amp[::5, 0] = 0.0
        for aname, amp in (("amp", planes[0]), ("zero-amp", zero_amp)):
            ps = [amp, *planes[1:]]
            pix = (*pd2[:4], holed2)
            got = ms.sep_bwd_cuda(*ps, *pix, g)
            again = ms.sep_bwd_cuda(*ps, *pix, g)
            hand = ms._sep_loglik_bwd_torch(*ps, *pix, g)
            leaves = [t.detach().clone().requires_grad_(True) for t in ps]
            auto = torch.autograd.grad(ms._sep_loglik_torch(*leaves, *pix), leaves, g)
            torch.cuda.synchronize()
            for name, a, h, w, a2 in zip(("amp", "cx", "cy", "iv"), got, hand, auto, again):
                what = f"K8-bwd B={b} {aname} d_{name}"
                max_abs_err(a, h, *BWD_TOL, what + " vs plain K8-bwd")
                errs["bwd"] = max(errs["bwd"], max_abs_err(a, w, *BWD_TOL, what + " vs autograd"))
                check(torch.equal(a, a2), f"{what}: two calls differ")
    for b, c, h, w in SEP_GRID:
        sep_shape_check(device, b, c, h, w, errs)
    print(f"[kernels] K8 matches the plain versions and K1 on config 1's stamp and at the "
          f"{len(SEP_GRID)} (B, C, H, W) of the grid (max abs err {errs}); K8 is bitwise "
          f"deterministic", flush=True)
    return errs


def sep_shape_check(device, b, c, h, w, errs, chunk=4096):
    """K8 on ``random_sep_problem(b, c, h, w)`` (every 5th chain's first
    component at zero amplitude, holed mask): K8-fwd against its plain
    version and K1, full and holed masks, centered both ways; K8-bwd
    against its plain version and torch autograd through the plain forward
    (the plain versions a chunk of chains at a time); both twice, bitwise
    equal."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pix, g = ms.random_sep_problem(b, c, h, w, seed=b + c + w)
    planes = [torch.as_tensor(a, device=device) for a in planes]
    pix = [torch.as_tensor(a, device=device) for a in pix]
    g = torch.as_tensor(g, device=device)
    parts = [slice(i, i + chunk) for i in range(0, b, chunk)]
    shape = f"B={b} C={c} {h}x{w}"
    for mname, px in (("holed", pix), ("full", (*pix[:4], torch.ones_like(pix[4])))):
        k1_planes, k1_pix = ms.sep_as_k1(*planes, *px)
        for centered in (False, True):
            what = f"{shape} mask={mname} centered={centered}"
            got = ms.sep_fwd_cuda(*planes, *px, centered=centered)
            again = ms.sep_fwd_cuda(*planes, *px, centered=centered)
            want = torch.cat([ms._sep_loglik_torch(*(t[sl] for t in planes), *px,
                                                   centered=centered) for sl in parts])
            k1 = mf.loglik_fwd_cuda(*k1_planes, *k1_pix, centered=centered)
            torch.cuda.synchronize()
            errs["fwd"] = max(errs["fwd"], max_abs_err(got, want, *SEP_TOL, "K8-fwd " + what))
            max_abs_err(got, k1, *SEP_TOL, "K8-fwd vs K1-fwd " + what)
            check(torch.equal(got, again), f"K8-fwd {what}: two calls differ")
    got = ms.sep_bwd_cuda(*planes, *pix, g)
    again = ms.sep_bwd_cuda(*planes, *pix, g)
    hand, auto = [], []
    for sl in parts:
        ps = [t[sl] for t in planes]
        hand.append(ms._sep_loglik_bwd_torch(*ps, *pix, g[sl]))
        leaves = [t.detach().clone().requires_grad_(True) for t in ps]
        auto.append(torch.autograd.grad(ms._sep_loglik_torch(*leaves, *pix), leaves, g[sl]))
    torch.cuda.synchronize()
    for i, name in enumerate(("amp", "cx", "cy", "iv")):
        what = f"K8-bwd {shape} d_{name}"
        max_abs_err(got[i], torch.cat([x[i] for x in hand]), *BWD_TOL, what + " vs plain")
        errs["bwd"] = max(errs["bwd"], max_abs_err(got[i], torch.cat([x[i] for x in auto]),
                                                   *BWD_TOL, what + " vs autograd"))
        check(torch.equal(got[i], again[i]), f"{what}: two calls differ")


# ---------------------------------------------------------------------------
# oracle and parity
# ---------------------------------------------------------------------------

def oracle_checks(device, config5):
    """Phase 5: the card's log-likelihoods at the truth against the fp64
    NumPy oracle (config 1 and config 5), and config 5's parity gate."""
    from celeste_tpu_torch.bench.config5 import build_config5, config5_parity_gap
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.kernels.mog_field import batched_stamp_loglik
    from celeste_tpu_torch.oracle.forward import (
        oracle_poisson_loglik, oracle_scene_lambda, oracle_star_lambda,
    )

    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=0, device=device)
    ost = scene.oracle_stamps[0]
    want = oracle_poisson_loglik(oracle_star_lambda(src["u"], src["flux"][2], ost),
                                 ost["counts"])
    x = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])]])
    got = batched_stamp_loglik(torch.as_tensor(x[None], dtype=torch.float32, device=device),
                               scene.stamps[0], band=0, kind="star", n_bands=1)
    err = max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL, "config-1 loglik vs oracle")
    print(f"[oracle] config 1 loglik at truth: card {float(got[0]):.3f} oracle {want:.3f} "
          f"abs err {err:.4g}", flush=True)

    logd, logd_dense, vec, info = config5
    ost = info["oracle_stamp"]
    srcs = [dict(s, flux=float(s["flux"][2])) for s in info["sources"]]
    want = oracle_poisson_loglik(oracle_scene_lambda(srcs, ost), ost["counts"])
    planes = tf.scene_planes_blocked(info["scene"], vec[None], info["stamp"], 0)
    with torch.no_grad():
        got = tf.tiled_field_loglik(planes, info["tiled_data"], n_comp=3)
    err = max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL, "config-5 loglik vs oracle")
    print(f"[oracle] config 5 tiled loglik at truth: card {float(got[0]):.3f} oracle "
          f"{want:.3f} abs err {err:.4g}", flush=True)

    gap, rel = config5_parity_gap(logd, logd_dense, vec)
    check(gap < 1.0, f"config-5 tiled-vs-dense gap {gap:.4g} nats >= 1")
    cut, _, _, _ = build_config5(radii_scale=0.05, device=device)
    gap_cut, _ = config5_parity_gap(cut, logd_dense, vec)
    check(gap_cut > 100.0, f"a 0.05 radii cut moved the gap only to {gap_cut:.4g} nats")
    print(f"[parity] config 5 tiled vs dense: gap {gap:.6g} nats (rel {rel:.3g}); "
          f"radii x0.05: {gap_cut:.6g} nats", flush=True)


def dense_gradient_check(device, config5):
    """Phase 6: config 5's dense reference (48x128 field, 12 sources, C=126)
    takes its ``value_and_grad`` on the card at B=64 through K1-bwd; its
    likelihood cotangents are held against the plain backward at
    BWD_TOL."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    _, logd_dense, vec, info = config5
    rng = np.random.default_rng(12)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(DENSE_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    before = mf.launch_counts()["mog_field_loglik_bwd"]
    val, grad = value_and_grad(logd_dense, vecs)
    torch.cuda.synchronize()
    check(mf.launch_counts()["mog_field_loglik_bwd"] == before + 1,
          "the dense value_and_grad did not launch K1-bwd once")
    check(bool(torch.isfinite(val).all() and torch.isfinite(grad).all()),
          "config-5 dense value_and_grad: non-finite")
    planes = [p.contiguous() for p in scene_field_planes(info["scene"], vecs, info["stamp"], 0)]
    pd = mf.stamp_pixel_data(info["stamp"])
    g = torch.ones(DENSE_CHAINS, dtype=torch.float32, device=device)
    got = mf.loglik_bwd_cuda(*planes, *pd, g)
    want = mf._loglik_bwd_torch(*planes, *pd, g)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, w, *BWD_TOL, f"config-5 dense K1-bwd d_{name}")
              for name, a, w in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, want))
    print(f"[dense] config 5 dense value_and_grad at B={DENSE_CHAINS} ({planes[0].shape[1]} "
          f"components, {pd[0].shape[1]} pixels) on the card: finite; K1-bwd vs plain max abs "
          f"err {err:.4g}", flush=True)


def oracle_checks_23(device):
    """The card's log-likelihoods at the truth against the fp64 oracle: config
    2 per band (five bands, K1) and config 3 (K1)."""
    from celeste_tpu_torch.kernels.mog_field import batched_stamp_loglik
    from celeste_tpu_torch.oracle.forward import (
        oracle_galaxy_lambda, oracle_poisson_loglik, oracle_star_lambda,
    )

    scene = ugriz_scene(device)
    src = scene.sources[0]
    x = np.concatenate([scene.wcs.equa2duas(src["u"]), np.log(src["flux"])])
    x = torch.as_tensor(x[None], dtype=torch.float32, device=device)
    errs = []
    for b, (stamp, ost) in enumerate(zip(scene.stamps, scene.oracle_stamps)):
        want = oracle_poisson_loglik(oracle_star_lambda(src["u"], src["flux"][b], ost),
                                     ost["counts"])
        got = batched_stamp_loglik(x, stamp, band=b, kind="star", n_bands=5)
        errs.append(max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL,
                                f"config-2 band {b} loglik vs oracle"))
    print(f"[oracle] config 2 loglik at truth, per band (ugriz): abs err "
          f"{', '.join(f'{e:.4g}' for e in errs)}", flush=True)
    scene = galaxy_scene(device)
    src, ost = scene.sources[0], scene.oracle_stamps[0]
    want = oracle_poisson_loglik(oracle_galaxy_lambda(
        src["u"], src["flux"][2], src["theta_dev"], src["sigma"], src["ab"], src["phi"], ost),
        ost["counts"])
    t, ab = src["theta_dev"], src["ab"]
    x = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2]),
                        np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)),
                        src["phi"]]])
    got = batched_stamp_loglik(torch.as_tensor(x[None], dtype=torch.float32, device=device),
                               scene.stamps[0], band=0, kind="galaxy", n_bands=1)
    err = max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL, "config-3 loglik vs oracle")
    print(f"[oracle] config 3 loglik at truth: card {float(got[0]):.3f} oracle {want:.3f} "
          f"abs err {err:.4g}", flush=True)


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def config1_path(device):
    """Phase 6: config 1 through run_experiment, MH then HMC."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import mog_field as mf

    runs = []
    for sampler, overrides in (("mh", {}), ("hmc", STAR_HMC)):
        cfg = copy.deepcopy(CONFIGS["star_single"])
        cfg.device, cfg.sampler = str(device), sampler
        for k, v in overrides.items():
            setattr(cfg, k, v)
        t0 = time.perf_counter()
        res = run_experiment(cfg)
        torch.cuda.synchronize()
        runs.append((sampler, cfg, res, time.perf_counter() - t0, dict(mf.launch_counts())))
    return runs


def report_config1(sampler, cfg, res, seconds, counts_after):
    samples = res["samples"]
    check(samples.shape == (cfg.n_chains, cfg.n_steps, 3),
          f"{sampler}: samples shape {samples.shape}")
    check(bool(np.isfinite(samples).all()), f"{sampler}: non-finite samples")
    mean, std, x0 = res["mean"], res["std"], res["x0"]
    rhat_max, ess_min = float(np.max(res["rhat"])), float(np.min(res["ess"]))
    z = np.abs(mean - x0) / std
    print(f"[config 1] star_single sampler={sampler} chains={cfg.n_chains} "
          f"steps={cfg.n_steps} warmup={cfg.n_warmup if sampler == 'hmc' else 0} "
          f"wall={seconds:.3f}s accept={res['accept_rate']:.4f} "
          f"step_size={res.get('step_size', 0.01)} max_rhat={rhat_max:.4f} "
          f"min_ess={ess_min:.1f} launches_so_far={counts_after}", flush=True)
    for name, m, s, t, zz in zip(("du_e", "du_n", "log_flux"), mean, std, x0, z):
        print(f"    {name}: {m:.6f} +- {s:.6f}  truth {t:.6f}  |z|={zz:.3f}", flush=True)
    check(rhat_max <= 1.1, f"{sampler}: max R-hat {rhat_max:.4f} > 1.1")
    check(bool(np.all(z <= 5.0)), f"{sampler}: truth outside mean +- 5 std (|z|={z})")


def config5_path(device):
    """Phase 7: config 5 at full width, then crowded_field through the entry
    point.  Returns the stamp kernels' counts after the dense parity probe."""
    from celeste_tpu_torch.bench.config5 import (
        build_config5, config5_parity_gap, config5_warmup_and_whiten, measure_chees_z,
        measure_nuts_z,
    )
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import mog_field as mf

    t0 = time.perf_counter()
    logd, logd_dense, vec, info = build_config5(device=device)
    gap, _ = config5_parity_gap(logd, logd_dense, vec)
    dense_counts = mf.launch_counts()    # the dense probe's K1 calls (8 chains)
    check(gap < 1.0, f"config-5 parity gap {gap:.4g} nats >= 1")
    prep = config5_warmup_and_whiten(logd, vec, n_chains=C5_CHAINS)
    t_prep = time.perf_counter() - t0
    chees = measure_chees_z(prep)
    nuts = measure_nuts_z(prep, **C5_NUTS)
    wall = time.perf_counter() - t0
    print(f"[config 5] 12 sources, 48x128, {C5_CHAINS} chains: prep {t_prep:.3f}s "
          f"(step {prep['step_size']:.5f}, z-space step {prep['step_z']:.5f}), "
          f"flow wall {wall:.3f}s", flush=True)
    for name, arm in (("ChEES", chees), ("NUTS", nuts)):
        extra = (f"eps={arm['eps']:.4f} traj={arm['traj']:.4f}" if name == "ChEES"
                 else f"mean_depth={arm['tree_depth']:.3f}")
        print(f"    {name}(z): min_ess_per_s={arm['min_ess_per_s']:.6g} "
              f"min_ess={float(arm['ess'].min()):.1f} accept={arm['accept']:.4f} "
              f"leapfrogs_per_step={arm['n_leapfrog']:.3f} divergence={arm['divergence']:.4f} "
              f"max_rhat={arm['max_rhat']:.4f} wall={arm['wall_s']:.3f}s {extra}", flush=True)
        check(arm["finite"], f"config-5 {name}: non-finite samples")
        check(arm["divergence"] <= 0.05, f"config-5 {name}: divergence {arm['divergence']:.4f}")
    check(chees["accept"] >= 0.4, f"config-5 ChEES accept {chees['accept']:.4f} < 0.4")
    check(chees["max_rhat"] <= 1.1, f"config-5 ChEES max R-hat {chees['max_rhat']:.4f} > 1.1")
    whitening_check(prep)

    cfg = copy.deepcopy(CONFIGS["crowded_field"])
    cfg.device, cfg.tiled, cfg.n_galaxies = str(device), True, 2
    for k, v in ENTRY_CROWDED.items():
        setattr(cfg, k, v)
    t1 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    check(res["samples"].shape == (cfg.n_chains, cfg.n_steps, 8 * 3 + 2 * 7),
          f"crowded_field samples shape {res['samples'].shape}")
    check(bool(np.isfinite(res["samples"]).all()), "crowded_field: non-finite samples")
    print(f"[entry] run_experiment crowded_field tiled=true n_galaxies=2 chains={cfg.n_chains} "
          f"warmup={cfg.n_warmup} steps={cfg.n_steps} n_leapfrog={cfg.n_leapfrog}: "
          f"wall={time.perf_counter() - t1:.3f}s accept={res['accept_rate']:.4f} "
          f"divergence={res['divergence_rate']:.4f} eps={res['step_size']:.4f} "
          f"traj={res['trajectory_length']:.4f} max_rhat={float(np.max(res['rhat'])):.4f} "
          f"min_ess={float(np.min(res['ess'])):.1f}", flush=True)
    return dense_counts


def multiband_path(device):
    """Config 5 in three bands (g, r, i) at full width, through the JAX bench's
    stage: ``build_config5_multiband`` -> the parity gate (gap < 1 nat; radii
    cut to 0.05 trips it above 100) -> each band's tiled ll at the truth
    against the fp64 oracle -> the committed artifacts' saved logps against a
    live evaluation (printed) -> one gradient's launches -> warmup and
    whitening -> ChEES, cut by MULTIBAND_PREP and MULTIBAND_CHEES.  Gates:
    finite samples, accept >= 0.4, divergence <= 0.05; max split-R-hat
    printed.  Returns (the three-band build, the tiled launches of one
    gradient at C5_CHAINS)."""
    from celeste_tpu_torch.bench.config5 import (
        build_config5_multiband, config5_parity_gap, config5_warmup_and_whiten, measure_chees_z,
    )
    from celeste_tpu_torch.inference import whiten_logdensity
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.interop import load_config5_prep
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.oracle.forward import oracle_poisson_loglik, oracle_scene_lambda

    t0 = time.perf_counter()
    multiband = build_config5_multiband(device=device)
    logd, logd_dense, vec, info = multiband
    gap, rel = config5_parity_gap(logd, logd_dense, vec)
    check(gap < 1.0, f"three-band tiled-vs-dense gap {gap:.4g} nats >= 1")
    cut = build_config5_multiband(radii_scale=0.05, device=device)[0]
    gap_cut, _ = config5_parity_gap(cut, logd_dense, vec)
    check(gap_cut > 100.0, f"a 0.05 radii cut moved the three-band gap only to {gap_cut:.4g}")
    print(f"[config 5 gri] D={vec.shape[0]}, bands {info['bands']}: tiled vs dense gap "
          f"{gap:.6g} nats (rel {rel:.3g}); radii x0.05: {gap_cut:.6g} nats", flush=True)

    errs = []
    for i, (stamp, ost, band) in enumerate(zip(info["stamps"], info["oracle_stamps"],
                                               info["bands"])):
        srcs = [dict(s, flux=float(s["flux"][band])) for s in info["sources"]]
        want = oracle_poisson_loglik(oracle_scene_lambda(srcs, ost), ost["counts"])
        planes = tf.scene_planes_blocked(info["scene"], vec[None], stamp, i)
        with torch.no_grad():
            got = tf.tiled_field_loglik(planes, info["tiled_data"][i], n_comp=3)
        errs.append(max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL,
                                f"three-band config 5, band {band}: tiled loglik vs oracle"))
    print(f"[oracle] config 5 gri tiled loglik at truth, per band: abs err "
          f"{', '.join(f'{e:.4g}' for e in errs)}", flush=True)

    art = Path(__file__).resolve().parent / "celeste_tpu" / "bench" / "artifacts"
    prep_a, chees_a = (load_config5_prep(art / f"{n}.npz", device) for n in MULTIBAND_ARTIFACTS)
    logd_z = whiten_logdensity(logd, prep_a["m_hat"], prep_a["cov_hat"])[0]
    with torch.no_grad():
        gaps = {name: float((f(x[:8]).double() - saved[:8].double()).abs().max())
                for name, f, x, saved in (
                    ("prep states_x", logd, prep_a["states_x"].x, prep_a["states_x"].logp),
                    ("prep states_z", logd_z, prep_a["states_z"].x, prep_a["states_z"].logp),
                    ("chees st", logd_z, chees_a["st"].xs, chees_a["st"].logps))}
    print(f"[artifacts] three-band warm-start files, saved logp against a live evaluation on "
          f"the first 8 chains (max abs, nats): {gaps}", flush=True)

    rng = np.random.default_rng(8)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(C5_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    before = tf.launch_counts()
    value_and_grad(logd, vecs)
    torch.cuda.synchronize()
    per_grad = {k: v - before[k] for k, v in tf.launch_counts().items()}
    n_buckets = [len(d.buckets) for d in info["tiled_data"]]
    print(f"[config 5 gri] launches per gradient at B={C5_CHAINS}: {per_grad} (bands x buckets "
          f"= {' + '.join(map(str, n_buckets))})", flush=True)
    check(per_grad["tiled_field_fwd_lam"] == per_grad["tiled_field_bwd"] == sum(n_buckets),
          "a three-band gradient does not launch K3 and K4 once per band and bucket")

    t1 = time.perf_counter()
    prep = config5_warmup_and_whiten(logd, vec, n_chains=C5_CHAINS, **MULTIBAND_PREP)
    t_prep = time.perf_counter() - t1
    chees = measure_chees_z(prep, **MULTIBAND_CHEES)
    print(f"[config 5 gri] 12 sources, 48x128, three bands, {C5_CHAINS} chains, "
          f"{MULTIBAND_PREP} {MULTIBAND_CHEES}: prep {t_prep:.3f}s (step "
          f"{prep['step_size']:.5f}, z-space step {prep['step_z']:.5f}); ChEES(z): "
          f"min_ess_per_s={chees['min_ess_per_s']:.6g} min_ess={float(chees['ess'].min()):.1f} "
          f"accept={chees['accept']:.4f} leapfrogs_per_step={chees['n_leapfrog']:.3f} "
          f"divergence={chees['divergence']:.4f} max_rhat={chees['max_rhat']:.4f} "
          f"eps={chees['eps']:.4f} traj={chees['traj']:.4f} wall={chees['wall_s']:.3f}s; "
          f"phase wall {time.perf_counter() - t0:.3f}s", flush=True)
    check(chees["finite"], "three-band ChEES: non-finite samples")
    check(chees["accept"] >= 0.4, f"three-band ChEES accept {chees['accept']:.4f} < 0.4")
    check(chees["divergence"] <= 0.05,
          f"three-band ChEES divergence {chees['divergence']:.4f} > 0.05")
    return multiband, per_grad


def multiband_timings(device, card, multiband):
    """One three-band config-5 value_and_grad at B=1024, kernel and plain."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.model.priors import SourcePriors
    from celeste_tpu_torch.parallel.crowded import _crowded_logprior

    logd, _, vec, info = multiband
    rng = np.random.default_rng(8)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(C5_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    priors = SourcePriors()

    def logd_plain(v):
        ll = 0.0
        for i, (stamp, data) in enumerate(zip(info["stamps"], info["tiled_data"])):
            planes = tf.scene_planes_blocked(info["scene"], v, stamp, i)
            ll = ll + tf.tiled_field_loglik_plain(planes, data, n_comp=3, centered=True)
        return ll + _crowded_logprior(info["scene"], priors, v)

    lv, gv = value_and_grad(logd, vecs)
    lp, gp = value_and_grad(logd_plain, vecs)
    max_abs_err(lv, lp, *TILED_TOL, "three-band value_and_grad value: kernel vs plain")
    max_abs_err(gv, gp, *TILED_BWD_TOL, "three-band value_and_grad gradient: kernel vs plain")
    out = {"vg_ms": time_ms(lambda: value_and_grad(logd, vecs), 10),
           "vg_plain_ms": time_ms(lambda: value_and_grad(logd_plain, vecs), 2)}
    print(f"[timing] three-band config-5 value_and_grad, B={C5_CHAINS}: kernel "
          f"{out['vg_ms']:.6f} ms, plain {out['vg_plain_ms']:.6f} ms, card: {card}", flush=True)
    return out


def whitening_check(prep):
    """The card's whitening maps against float64 on the host: TF32 in the
    44x44 products would show as ~1e-3 relative error."""
    from celeste_tpu_torch.inference import whiten_logdensity

    m_hat, cov_hat = prep["whiten_moments"]
    _, to_x_h, to_z_h = whiten_logdensity(lambda x: x, m_hat.cpu(), cov_hat.cpu())
    z = prep["states_z"].x[:256]
    x = prep["to_x"](z)
    max_abs_err(x.cpu(), to_x_h(z.cpu()), 1e-6, 1e-6, "to_x on the card vs the host")
    max_abs_err(prep["to_z"](x).cpu(), to_z_h(x.cpu()), 0.0, 1e-5, "to_z on the card vs the host")
    round_trip = float((prep["to_z"](x) - z).abs().max())
    print(f"[whiten] card maps equal the host's float64 maps; to_z(to_x(z)) - z max "
          f"{round_trip:.3g} (bounded by float32 x: |x| ~ 9 against stds ~ 6e-3)", flush=True)


def sharded_value_and_grad(sharded5, rect):
    """(log posterior [B], its gradient [B, 12, 7], the likelihood's
    gradient [B, 12, 7]) of the sharded config-5 posterior."""
    from celeste_tpu_torch.inference.hmc import value_and_grad

    val, grad = value_and_grad(sharded5["logpost"], rect)
    _, grad_ll = value_and_grad(sharded5["loglik"], rect)
    return val, grad, grad_ll


def sharded_world2_rank(n_chains):
    """One of two gloo ranks on the one card, mesh (1, 2): the sharded
    config-5 posterior's value and gradient at the parity states, on the
    host."""
    from celeste_tpu_torch.bench.config5 import build_config5, build_config5_sharded
    from celeste_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", torch.cuda.current_device())
    info = build_config5(device=device)[3]
    s5 = build_config5_sharded(info, make_mesh({"chains": 1, "sources": 2}, "cuda"))
    val, grad, _ = sharded_value_and_grad(s5, rect_states(s5, n_chains, seed=17))
    return val.cpu(), grad.cpu()


def sharded_path(device, config5):
    """Phase 8 on a one-rank NCCL mesh: parity of the sharded config-5
    posterior, its gap to the dense reference, and sharded ChEES at 1024
    chains.  Returns (the sharded pieces, the parity states' value and
    gradient)."""
    from celeste_tpu_torch.bench.config5 import build_config5_sharded
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.parallel import ensemble_diagnostics, make_mesh, run_sharded_chees
    from celeste_tpu_torch.parallel.crowded import STAR_D

    _, logd_dense, vec, info = config5
    mesh = make_mesh({"chains": 1, "sources": 1}, "cuda")
    s5 = build_config5_sharded(info, mesh)
    scene = info["scene"]
    t0 = time.perf_counter()
    rect = rect_states(s5, C5_CHAINS, seed=17)
    val, grad, grad_ll = sharded_value_and_grad(s5, rect)
    want, want_g = value_and_grad(s5["logd_ref"], scene.from_rect(rect))
    err_v = max_abs_err(val, want, *TILED_TOL, "sharded config-5 value vs single-device tiled")
    err_g = max_abs_err(scene.from_rect(grad), want_g, *TILED_BWD_TOL,
                        "sharded config-5 gradient vs single-device tiled")
    for i, kind in enumerate(scene.kinds):
        if kind == "star":
            check(bool((grad_ll[:, i, STAR_D(scene.n_bands):] == 0).all()),
                  f"source {i}: the padding's likelihood gradient is not 0")
    with torch.no_grad():
        probes = rect_states(s5, 8, seed=9)
        gap = float((s5["logpost"](probes).double()
                     - logd_dense(scene.from_rect(probes)).double()).abs().max())
    check(gap < 1.0, f"sharded config-5 gap to the dense reference {gap:.4g} nats >= 1")
    print(f"[sharded] config 5 on mesh (1, 1), nccl, {C5_CHAINS} states: value max abs err "
          f"{err_v:.4g}, gradient {err_g:.4g} vs the single-device tiled posterior (same "
          f"radii); gap to the dense reference {gap:.6g} nats", flush=True)

    d = int(np.prod(s5["rect"].shape))
    rng = np.random.default_rng(23)
    # start near the truth; the star padding (0 at the truth) gets its own spread
    x0 = (rect_states(s5, C5_CHAINS, seed=29).reshape(C5_CHAINS, d)
          + torch.as_tensor(0.01 * rng.normal(size=(C5_CHAINS, d)), dtype=torch.float32,
                            device=device) * (s5["rect"].reshape(-1) == 0))
    gen = torch.Generator(device=device)
    gen.manual_seed(31)

    def logd_flat(x):
        return s5["logpost"](x.reshape(x.shape[0], *s5["rect"].shape))

    t1 = time.perf_counter()
    samples, _, eps, traj, info_c = run_sharded_chees(gen, logd_flat, x0, mesh, **SHARDED_CHEES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    diag = ensemble_diagnostics(samples[:, samples.shape[1] // 4:], mesh)
    chees = {"wall_s": wall, "eps": float(eps), "traj": float(traj),
             "accept": float(info_c.accept_rate.mean()),
             "divergence": float(info_c.divergence_rate.mean()),
             "n_leapfrog": float(info_c.n_leapfrog.double().mean()),
             "min_ess": float(diag["ess"].min()), "max_rhat": float(diag["rhat"].max()),
             "finite": bool(torch.isfinite(samples).all())}
    chees["min_ess_per_s"] = chees["min_ess"] / wall
    print(f"[sharded] run_sharded_chees, {C5_CHAINS} chains, D={d}, {SHARDED_CHEES}: "
          f"wall={wall:.3f}s eps={chees['eps']:.5f} traj={chees['traj']:.5f} "
          f"leapfrogs_per_step={chees['n_leapfrog']:.3f} accept={chees['accept']:.4f} "
          f"divergence={chees['divergence']:.4f} min_ess={chees['min_ess']:.1f} "
          f"min_ess_per_s={chees['min_ess_per_s']:.6g} max_rhat={chees['max_rhat']:.4f} "
          f"(parity and sampling {time.perf_counter() - t0:.3f}s)", flush=True)
    check(chees["finite"], "sharded ChEES: non-finite samples")
    check(chees["accept"] >= 0.4, f"sharded ChEES accept {chees['accept']:.4f} < 0.4")
    check(chees["divergence"] <= 0.05, f"sharded ChEES divergence {chees['divergence']:.4f}")
    return s5, (val, grad)


def sharded_world2(world1):
    """Phase 8, second part: two gloo ranks on the one card, mesh (1, 2),
    against the one-rank value and gradient; then ``dryrun_multichip(1)``."""
    from celeste_tpu_torch.multichip import dryrun_multichip
    from celeste_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(sharded_world2_rank, 2, C5_CHAINS, backend="gloo")
    val1, grad1 = (t.cpu() for t in world1)
    for r, (val, grad) in enumerate(ranks):
        ev = max_abs_err(val, val1, *TILED_TOL, f"world-2 rank {r} value vs world 1")
        eg = max_abs_err(grad, grad1, *TILED_BWD_TOL, f"world-2 rank {r} gradient vs world 1")
    check(torch.equal(ranks[0][1], ranks[1][1]), "the two source shards' gradients differ")
    print(f"[sharded] mesh (1, 2), gloo, two ranks on one card: value and gradient equal "
          f"world 1's (max abs err {ev:.4g}, {eg:.4g}; {time.perf_counter() - t0:.3f}s)",
          flush=True)
    t0 = time.perf_counter()
    out = dryrun_multichip(1, device="cuda")
    print(f"[entry] dryrun_multichip(1, device='cuda'): {out} ({time.perf_counter() - t0:.3f}s)",
          flush=True)


def entry_run(name, overrides, device):
    """One ``run_experiment`` of a config with ``overrides``, the stamp
    kernels' counters set to 0 just before and read just after."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import mog_field as mf

    cfg = copy.deepcopy(CONFIGS[name])
    cfg.device = str(device)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    mf.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    return cfg, res, time.perf_counter() - t0, dict(mf.launch_counts())


def report_entry(tag, cfg, res, seconds, counts, rhat_gate, periodic=()):
    """Print a run's summary; gate finite samples, max split-R-hat and the
    truth within mean +- 5 std (``periodic``: pi-periodic coordinates,
    compared in principal value)."""
    samples = res["samples"]
    check(samples.shape == (cfg.n_chains, cfg.n_steps, res["x0"].size),
          f"{tag}: samples shape {samples.shape}")
    check(bool(np.isfinite(samples).all()), f"{tag}: non-finite samples")
    mean, std, x0 = res["mean"], res["std"], res["x0"]
    err = np.abs(mean - x0)
    for i in periodic:
        err[i] = min(err[i], abs(err[i] - np.pi))
    z = err / std
    rhat_max = float(np.max(res["rhat"]))
    extra = " ".join(f"{k}={res[k]:.4f}" for k in ("accept_rate", "divergence_rate", "step_size",
                                                    "evals_per_sweep", "calls_per_sweep")
                     if k in res)
    print(f"[{tag}] chains={cfg.n_chains} steps={cfg.n_steps} "
          f"warmup={cfg.n_warmup if cfg.sampler not in ('mh', 'slice') else 0} "
          f"wall={seconds:.3f}s {extra} max_rhat={rhat_max:.4f} "
          f"min_ess={float(np.min(res['ess'])):.1f} launches={counts}", flush=True)
    print("    |z| of the truth: " + " ".join(f"{v:.3f}" for v in z), flush=True)
    check(rhat_max <= rhat_gate, f"{tag}: max R-hat {rhat_max:.4f} > {rhat_gate}")
    check(bool(np.all(z <= 5.0)), f"{tag}: truth outside mean +- 5 std (|z|={z})")


def configs23_path(device):
    """Configs 2 and 3 through ``run_experiment``: star_ugriz with HMC and
    with the slice sampler (32 chains, five 25x25 bands), galaxy with NUTS
    (32 chains, 31x31).  Returns the runs by name."""
    runs = {}
    for key, name, overrides, rhat_gate in (
            ("ugriz hmc", "star_ugriz", dict(UGRIZ_HMC, sampler="hmc"), 1.1),
            ("ugriz slice", "star_ugriz", dict(UGRIZ_SLICE, sampler="slice"), 1.15),
            ("galaxy nuts", "galaxy", GALAXY_NUTS, 1.2)):
        cfg, res, seconds, counts = entry_run(name, overrides, device)
        report_entry(f"entry {name} {cfg.sampler}", cfg, res, seconds, counts, rhat_gate,
                     periodic=(6,) if name == "galaxy" else ())
        check(counts["mog_field_loglik_fwd"] > 0, f"{name} {cfg.sampler} never launched K1-fwd")
        if cfg.sampler != "slice":
            check(counts["mog_field_loglik_bwd"] > 0,
                  f"{name} {cfg.sampler} never launched K1-bwd")
        runs[key] = (cfg, res, seconds, counts)
    nuts = runs["galaxy nuts"][1]
    check(nuts["divergence_rate"] < 0.05, f"galaxy NUTS divergence {nuts['divergence_rate']:.4f}")

    # slice against HMC on config 2: means within 0.5 sigma, widths within
    # (0.65, 1.55) (tests/test_e2e_multiband.py)
    h, sl = runs["ugriz hmc"][1], runs["ugriz slice"][1]
    scale = np.maximum(h["std"], sl["std"])
    ratio = sl["std"] / h["std"]
    print(f"[entry] star_ugriz slice vs HMC: |mean gap| / sigma "
          f"{' '.join(f'{v:.3f}' for v in np.abs(sl['mean'] - h['mean']) / scale)}; "
          f"width ratio {' '.join(f'{v:.3f}' for v in ratio)}", flush=True)
    check(bool(np.all(np.abs(sl["mean"] - h["mean"]) < 0.5 * scale)),
          "star_ugriz: slice and HMC means differ by more than 0.5 sigma")
    check(bool(np.all((ratio > 0.65) & (ratio < 1.55))),
          f"star_ugriz: slice/HMC width ratio {ratio} outside (0.65, 1.55)")
    return runs


def ppc_path(device, runs):
    """The posterior-predictive check on config 2's r band (HMC draws) and on
    config 3 (NUTS draws), K7's counter set to 0 just before and read just
    after: the calibrated draws give p in (0.02, 0.98); with the source's
    log-flux set to -8, p < 0.02."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import CrowdedScene
    from celeste_tpu_torch.ppc import ppc_chi2_pvalue, ppc_lambda_draws, ppc_pixel_zscores

    cases = (("config 2 r band", ugriz_scene(device), 2, CrowdedScene(("star",), 5), 2 + 2,
              runs["ugriz hmc"][1]),
             ("config 3", galaxy_scene(device), 0, CrowdedScene(("galaxy",), 1), 2,
              runs["galaxy nuts"][1]))
    mf.reset_launch_counts()
    t0 = time.perf_counter()
    shapes = {}
    for tag, scene, band, cs, flux_slot, res in cases:
        stamp = scene.stamps[band]
        counts, mask = stamp.counts.cpu().numpy(), stamp.mask.cpu().numpy()
        kept = res["samples"][:, res["samples"].shape[1] // 4:]
        before = mf.launch_counts()["mog_field_render"]
        lam = ppc_lambda_draws(cs, kept, stamp, band=band, n_draws=PPC_DRAWS)
        check(lam.shape == (PPC_DRAWS,) + tuple(counts.shape) and bool(np.isfinite(lam).all()),
              f"PPC {tag}: lambda draws {lam.shape}")
        p, d_obs, d_rep = ppc_chi2_pvalue(lam, counts, mask=mask)
        z = ppc_pixel_zscores(lam, counts)
        wrong = kept.copy()
        wrong[..., flux_slot] = -8.0
        lam_w = ppc_lambda_draws(cs, wrong, stamp, band=band, n_draws=PPC_DRAWS)
        p_w, _, _ = ppc_chi2_pvalue(lam_w, counts, mask=mask)
        print(f"[ppc] {tag}: p={p:.4f} (deviance obs {d_obs.mean():.2f}, rep {d_rep.mean():.2f}), "
              f"max |z| {np.abs(z).max():.3f}; source flux removed: p={p_w:.4f}", flush=True)
        check(0.02 < p < 0.98, f"PPC {tag}: p={p:.4f} outside (0.02, 0.98)")
        check(p_w < 0.02, f"PPC {tag}: the missing source gives p={p_w:.4f} >= 0.02")
        shapes[tag] = (cs, kept, stamp, band,
                       mf.launch_counts()["mog_field_render"] - before)
    counts_k7 = mf.launch_counts()["mog_field_render"]
    print(f"[ppc] {time.perf_counter() - t0:.3f}s; K7 launches {counts_k7}", flush=True)
    check(counts_k7 > 0, "the PPC path never launched K7")
    return counts_k7, shapes


def sep_entry_path(device):
    """K8 through its entry point: ``batched_stamp_loglik(impl="sep")`` and
    its gradient at B=65536 on config 1's stamp, K8's counters set to 0 just
    before and read just after, held against the general kernel's value and
    gradient.  Returns K8's counts and K1's (the general kernel's call)."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    stamp, vecs = config1_batch(device)
    ms.reset_launch_counts()
    val, grad = value_and_grad(
        lambda v: mf.batched_stamp_loglik(v, stamp, band=0, n_bands=1, impl="sep"), vecs)
    torch.cuda.synchronize()
    counts = ms.launch_counts()
    mf.reset_launch_counts()
    want, want_g = value_and_grad(
        lambda v: mf.batched_stamp_loglik(v, stamp, band=0, n_bands=1), vecs)
    k1_counts = mf.launch_counts()
    ev = max_abs_err(val, want, *SEP_TOL, "impl=sep value vs K1 at B=65536")
    eg = max_abs_err(grad, want_g, *BWD_TOL, "impl=sep gradient vs K1 at B=65536")
    print(f"[entry] batched_stamp_loglik(impl='sep') value_and_grad at B={BENCH_CHAINS}: "
          f"launches {counts}; against K1: value {ev:.4g}, gradient {eg:.4g}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"the impl='sep' entry point never launched {name}")
    return counts, k1_counts


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def config1_batch(device):
    """Config 1's 25x25 r-band stamp and B=65536 one-band star vectors
    scattered around the truth."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source

    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=0, device=device)
    x0 = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])]])
    rng = np.random.default_rng(0)
    vecs = torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(BENCH_CHAINS, 3)))
                           .astype(np.float32), device=device)
    return scene.stamps[0], vecs


def config1_timings(device, card):
    """B=65536 chains on one 25x25 r-band stamp."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.inference.problems import make_star_logdensity
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.model.params import StarParams
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    stamp, vecs = config1_batch(device)
    pd = mf.stamp_pixel_data(stamp)
    planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 0, "star", 1)]
    g = torch.ones(BENCH_CHAINS, dtype=torch.float32, device=device)
    t = {
        "fwd_ms": time_ms(lambda: mf.loglik_fwd_cuda(*planes, *pd), 20),
        "fwd_plain_ms": time_ms(lambda: mf._loglik_torch(*planes, *pd), 5),
        "bwd_ms": time_ms(lambda: mf.loglik_bwd_cuda(*planes, *pd, g), 20),
        "bwd_plain_ms": time_ms(lambda: mf._loglik_bwd_torch(*planes, *pd, g), 5),
        "e2e_ms": time_ms(lambda: mf.batched_stamp_loglik(vecs, stamp, band=0, n_bands=1,
                                                          pixel_data=pd), 20),
        "e2e_plain_ms": time_ms(lambda: mf._loglik_torch(
            *mf._field_planes(vecs, stamp, 0, "star", 1), *pd), 5),
    }
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=float(np.log(30.0)), log_ref_std=2.0))
    logd = make_star_logdensity([stamp], bands=[0], priors=priors, n_bands=1)

    def logd_plain(v):
        p = StarParams.from_vector(v, 1)
        ll = mf._loglik_torch(*mf._field_planes(v, stamp, 0, "star", 1), *pd)
        return ll + priors.star_logpdf(p) + StarParams.log_det_jacobian(v, 1)

    t["hmc_grad_ms"] = time_ms(lambda: value_and_grad(logd, vecs), 10)
    t["hmc_grad_plain_ms"] = time_ms(lambda: value_and_grad(logd_plain, vecs), 3)
    print(f"[timing] config 1: B={BENCH_CHAINS} chains, 25x25 r-band stamp, card: {card}",
          flush=True)
    for k, v in t.items():
        print(f"    {k} = {v:.6f} ms  ({BENCH_CHAINS / (v * 1e-3):.6e} chain-evals/s)",
              flush=True)
    return t


def config5_timings(device, card, config5):
    """K2, K3 and K4 over config 5's field at B=1024 and 4096, in ms per
    wrapper call (both occupancy buckets' launches timed together, divided by
    the number of launches, the unit in which the launch counters count),
    and one config-5 value_and_grad at B=1024, kernel and plain."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.parallel.crowded import _crowded_logprior
    from celeste_tpu_torch.model.priors import SourcePriors

    logd, _, vec, info = config5
    buckets = info["tiled_data"].bucket_tables
    out = {}
    for b in TIMING_CHAINS:
        planes = c5_planes(config5, b, seed=7)
        g = torch.ones(b, dtype=torch.float32, device=device)
        lams = [tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)[1]
                for bk in buckets]
        cols = [bk.columns(3, planes[0].shape[1]) for bk in buckets]
        lams_plain = [tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, 3)[1] for bk in buckets]
        reps = 20 if b == TIMING_CHAINS[0] else 5
        t = {
            "K2": time_ms(lambda: [tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
                                   for bk in buckets], reps),
            "K2_plain": time_ms(lambda: [tf._tiled_torch(planes, bk.tile_src, bk.pixels, 3)
                                         for bk in buckets], 2),
            "K3": time_ms(lambda: [tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels,
                                                         n_comp=3) for bk in buckets], reps),
            "K3_plain": time_ms(lambda: [tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, 3)
                                         for bk in buckets], 2),
            "K4": time_ms(lambda: [tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g,
                                                     *c, n_comp=3)
                                   for bk, lam, c in zip(buckets, lams, cols)], reps),
            "K4_plain": time_ms(lambda: [tf._tiled_bwd_torch(planes, bk.tile_src, bk.pixels,
                                                             lam, g, 3)
                                         for bk, lam in zip(buckets, lams_plain)], 2),
        }
        t = {k: v / len(buckets) for k, v in t.items()}
        out[b] = t
        print(f"[timing] config 5 tiled kernels, B={b}, 12 sources 48x128, ms per wrapper "
              f"call (the {len(buckets)} buckets' launches timed together / {len(buckets)}), "
              f"card: {card}", flush=True)
        for k, v in t.items():
            print(f"    {k} = {v:.6f} ms", flush=True)

    rng = np.random.default_rng(8)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(TIMING_CHAINS[0], vec.shape[0])),
                                       dtype=torch.float32, device=device)
    priors = SourcePriors()

    def logd_plain(v):
        planes = tf.scene_planes_blocked(info["scene"], v, info["stamp"], 0)
        ll = tf.tiled_field_loglik_plain(planes, info["tiled_data"], n_comp=3, centered=True)
        return ll + _crowded_logprior(info["scene"], priors, v)

    lv, gv = value_and_grad(logd, vecs)
    lp, gp = value_and_grad(logd_plain, vecs)
    max_abs_err(lv, lp, *TILED_TOL, "config-5 value_and_grad value: kernel vs plain")
    max_abs_err(gv, gp, *TILED_BWD_TOL, "config-5 value_and_grad gradient: kernel vs plain")
    out["vg_ms"] = time_ms(lambda: value_and_grad(logd, vecs), 10)
    out["vg_plain_ms"] = time_ms(lambda: value_and_grad(logd_plain, vecs), 2)
    print(f"[timing] config-5 value_and_grad, B={TIMING_CHAINS[0]}: kernel "
          f"{out['vg_ms']:.6f} ms, plain "
          f"{out['vg_plain_ms']:.6f} ms, card: {card}", flush=True)
    return out


def render_timings(card, sharded5, vg_single_ms):
    """K5 and K6 over the sharded config-5 tables (one launch per bucket) at
    B=1024 and 4096, kernel and plain, and one sharded value_and_grad at
    B=1024 beside the single-device one of this run."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import tiled_field as tf

    loglik = sharded5["loglik"]
    out = {}
    for b in TIMING_CHAINS:
        planes = [p.contiguous() for p in loglik.planes(rect_states(sharded5, b, seed=7))]
        gs = [torch.ones(bk.tile_src.shape[0], b, 1024, device=planes[0].device)
              for bk in loglik.buckets]
        cols = [bk.columns(3, planes[0].shape[1]) for bk in loglik.buckets]
        reps = 20 if b == TIMING_CHAINS[0] else 5
        out[b] = {
            "K5": time_ms(lambda: [tf.tiled_render_cuda(*planes, bk.tile_src, *bk.pixels,
                                                        n_comp=3) for bk in loglik.buckets], reps),
            "K5_plain": time_ms(lambda: [tf._tiled_render_torch(planes, bk.tile_src, *bk.pixels,
                                                                3) for bk in loglik.buckets], 2),
            "K6": time_ms(lambda: [tf.tiled_render_bwd_cuda(*planes, bk.tile_src, *bk.pixels, g,
                                                            *c, n_comp=3)
                                   for bk, g, c in zip(loglik.buckets, gs, cols)], reps),
            "K6_plain": time_ms(lambda: [tf._tiled_render_bwd_torch(planes, bk.tile_src,
                                                                    *bk.pixels, g, 3)
                                         for bk, g in zip(loglik.buckets, gs)], 2),
        }
        print(f"[timing] sharded config-5 render kernels, B={b}, one rank "
              f"({len(loglik.buckets)} bucket(s), one launch each), card: {card}", flush=True)
        for k, v in out[b].items():
            print(f"    {k} = {v:.6f} ms", flush=True)
    rect = rect_states(sharded5, TIMING_CHAINS[0], seed=8)
    out["vg_ms"] = time_ms(lambda: value_and_grad(sharded5["logpost"], rect), 10)
    print(f"[timing] sharded config-5 value_and_grad, B={TIMING_CHAINS[0]}, mesh (1, 1): "
          f"{out['vg_ms']:.6f} ms (single-device K3/K4 value_and_grad of this run "
          f"{vg_single_ms:.6f} ms), card: {card}", flush=True)
    return out


def sep_timings(device, card):
    """K8-fwd and K8-bwd at B=65536 on config 1's stamp, kernel and plain,
    timed in turns with K1-fwd and K1-bwd on the same chains (device ms per
    call: a CUDA graph of 20 calls, best of 3); and the entry point's
    value_and_grad with impl="sep" and with the general kernel."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    stamp, vecs = config1_batch(device)
    planes = [t.contiguous() for t in ms.star_planes_isotropic(vecs, stamp, 0, 1)]
    k1_planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 0, "star", 1)]
    pd2, pd1 = ms.stamp_pixel_data_2d(stamp), mf.stamp_pixel_data(stamp)
    g = torch.ones(BENCH_CHAINS, dtype=torch.float32, device=device)
    t = {}
    for turn in ("a", "b"):     # K1, K8, K8, K1
        order = ("K1", "K8") if turn == "a" else ("K8", "K1")
        for k in order:
            if k == "K1":
                fwd = graph_ms(lambda: mf.loglik_fwd_cuda(*k1_planes, *pd1))
                bwd = graph_ms(lambda: mf.loglik_bwd_cuda(*k1_planes, *pd1, g))
            else:
                fwd = graph_ms(lambda: ms.sep_fwd_cuda(*planes, *pd2))
                bwd = graph_ms(lambda: ms.sep_bwd_cuda(*planes, *pd2, g))
            t[f"{k}_fwd_ms"] = min(t.get(f"{k}_fwd_ms", fwd), fwd)
            t[f"{k}_bwd_ms"] = min(t.get(f"{k}_bwd_ms", bwd), bwd)
    t["K8_fwd_plain_ms"] = time_ms(lambda: ms._sep_loglik_torch(*planes, *pd2), 5)
    t["K8_bwd_plain_ms"] = time_ms(lambda: ms._sep_loglik_bwd_torch(*planes, *pd2, g), 3)
    for impl in ("sep", "general"):
        t[f"vg_{impl}_ms"] = time_ms(lambda: value_and_grad(
            lambda v: mf.batched_stamp_loglik(v, stamp, band=0, n_bands=1, impl=impl), vecs), 10)
    print(f"[timing] K8 against K1: B={BENCH_CHAINS} chains, config 1's 25x25 stamp, card: "
          f"{card}", flush=True)
    for k, v in t.items():
        print(f"    {k} = {v:.6f} ms  ({BENCH_CHAINS / (v * 1e-3):.6e} chain-evals/s)", flush=True)
    return t


def stamp_render_timings(device, card, config5):
    """K7 at B=1024 over config 5's 48x128 field (dense planes, C=126) and on
    config 2's 25x25 r-band stamp (C=3), kernel and plain."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    _, _, vec, info = config5
    rng = np.random.default_rng(6)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(C5_CHAINS, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    field = ([p.contiguous() for p in scene_field_planes(info["scene"], vecs, info["stamp"], 0)],
             mf.stamp_pixel_data(info["stamp"]))
    scene = ugriz_scene(device)
    svecs = torch.as_tensor(source_vecs(scene, "star", C5_CHAINS, seed=6), device=device)
    stamp = ([t.contiguous() for t in mf._field_planes(svecs, scene.stamps[2], 2, "star", 5)],
             mf.stamp_pixel_data(scene.stamps[2]))
    t = {}
    for name, (planes, (px, py, _, sky, _)) in (("field", field), ("stamp", stamp)):
        t[f"K7_{name}_ms"] = time_ms(lambda: mf.render_cuda(*planes, px, py, sky), 20)
        t[f"K7_{name}_plain_ms"] = time_ms(lambda: mf._render_torch(*planes, px, py, sky), 3)
    print(f"[timing] K7 at B={C5_CHAINS}: config 5's 48x128 field (C=126) and a 25x25 stamp "
          f"(C=3), card: {card}", flush=True)
    for k, v in t.items():
        print(f"    {k} = {v:.6f} ms", flush=True)
    return t


def k7_shape_timings(card, shapes):
    """K7 at the shapes where the PPC launches it (config 2's r band, C=3,
    and config 3's galaxy, C=48, both at PPC_DRAWS chains): the planes of
    the draws ``ppc_lambda_draws`` renders, device ms per call (a CUDA
    graph of 20 calls, best of 3) and the plain version's (CUDA events),
    the bound per call, this run's launches at that shape and the time
    lost, launches x (ms - bound).  ``shapes``:
    {tag: (scene, kept samples, stamp, band, launches)} from ``ppc_path``."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    rows = []
    for tag, (cs, kept, stamp, band, n) in shapes.items():
        flat = kept.reshape(-1, kept.shape[-1])
        idx = np.random.default_rng(0).choice(flat.shape[0], size=PPC_DRAWS, replace=False)
        vecs = torch.as_tensor(flat[idx], dtype=torch.float32, device=stamp.device)
        planes = [p.contiguous() for p in scene_field_planes(cs, vecs, stamp, band)]
        px, py, _, sky, _ = mf.stamp_pixel_data(stamp)
        ms = graph_ms(lambda: mf.render_cuda(*planes, px, py, sky))
        plain_ms = time_ms(lambda: mf._render_torch(*planes, px, py, sky), 5)
        b, c = planes[0].shape
        pix, pix_pad = stamp.counts.numel(), px.shape[1]
        bound_ms, bound_by = k7_bound(b, c, pix, pix_pad)
        rows.append({"kernel": "K7", "shape": tag, "chains": b, "components": c,
                     "pixels": pix, "pixels_padded": pix_pad, "launches": n, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "lost_s": n * (ms - bound_ms) * 1e-3})
    print(f"[timing] K7 where the PPC launches it (device ms per call: a CUDA graph of 20 "
          f"calls, best of 3), card: {card}", flush=True)
    for r in rows:
        print(f"    K7 {r['shape']}: B={r['chains']} C={r['components']} P={r['pixels']} "
              f"({r['pixels_padded']}) ms={r['ms']:.6f} plain={r['plain_ms']:.6f} "
              f"bound={r['bound_ms']:.6f} ({r['bound_by']}) launches={r['launches']} "
              f"lost={r['lost_s']:.6f} s", flush=True)
    return rows


def k7_bound(b, c, pix, pix_pad):
    """K7's bound per call for b chains of c components over pix real
    pixels (pix_pad rendered): a term's form and sum and its exponential per
    (chain, pixel, component); the planes and the pixel arrays read once,
    the [B, P] images written once."""
    f4 = 4
    return bound(b * pix * c * (FLOPS_TERM_FORM + FLOPS_TERM_SUM),
                 6 * b * c * f4 + 3 * pix_pad * f4 + b * pix_pad * f4, b * pix * c)


def bound(flops, nbytes, special):
    """(least time in ms, what bounds it) for ``flops`` float32 operations,
    ``special`` exponentials and logarithms and ``nbytes`` moved, at the
    card's peaks."""
    times = {"operations": flops / FP32_FLOPS_PER_S, "special functions": special / SPECIAL_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def k1_bounds(b, c, pix, pix_pad):
    """K1-fwd's and K1-bwd's bounds per call for b chains of c components
    on pix real pixels (pix_pad staged): the terms and pixels this data
    needs, the planes and pixel arrays read once, the outputs written
    once."""
    f4 = 4
    planes, pixel_arrays, terms = 6 * b * c * f4, 5 * pix_pad * f4, b * pix * c
    return {
        "K1-fwd": bound(terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM) + b * pix * FLOPS_PIXEL_LOGLIK,
                        planes + pixel_arrays + b * f4, terms + b * pix),
        "K1-bwd": bound(terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM + FLOPS_TERM_MOMENTS)
                        + b * pix * FLOPS_PIXEL_GLAM + b * c * FLOPS_ENTRY_EPILOGUE,
                        2 * planes + pixel_arrays + b * f4, terms),
    }


def k1_shape_inputs(device, config5):
    """K1's calls by the shape they have on each path: {name: (planes,
    pixel data, real pixels)} -- config 1 (64 chains), config 2 (32 chains,
    each band's call; the r band here), config 3 (32 chains, 31x31 galaxy),
    config 5's dense parity probe (8 chains, 126 components, 48x128) and
    config 1's stamp at the evals/s shape (65536 chains)."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    stamp, vecs = config1_batch(device)

    def star(n):
        return [t.contiguous() for t in mf._field_planes(vecs[:n], stamp, 0, "star", 1)]

    def five_band(scene, kind, band):
        v = torch.as_tensor(source_vecs(scene, kind, 32, seed=32), device=device)
        st = scene.stamps[band if len(scene.stamps) > 1 else 0]
        return [t.contiguous() for t in mf._field_planes(v, st, band, kind, 5)], st

    ug_planes, ug_stamp = five_band(ugriz_scene(device), "star", 2)
    gal_planes, gal_stamp = five_band(galaxy_scene(device), "galaxy", 2)
    _, _, vec, info = config5
    rng = np.random.default_rng(13)
    dense = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(8, vec.shape[0])),
                                        dtype=torch.float32, device=device)
    pd1 = mf.stamp_pixel_data(stamp)
    return {
        "config 1": (star(64), pd1, 625),
        "config 2": (ug_planes, mf.stamp_pixel_data(ug_stamp), 625),
        "config 3": (gal_planes, mf.stamp_pixel_data(gal_stamp), 961),
        "config 5 dense": ([p.contiguous() for p in scene_field_planes(info["scene"], dense,
                                                                       info["stamp"], 0)],
                           mf.stamp_pixel_data(info["stamp"]), 48 * 128),
        "B=65536": (star(BENCH_CHAINS), pd1, 625),
    }


def k1_shape_timings(device, card, config5, launches):
    """K1-fwd and K1-bwd at each shape where the paths call them: device
    ms per call (a CUDA graph of 20 calls, best of 3 replays), the bound per
    call, the launches of this run at that shape, and the time lost,
    launches x (ms - bound).  ``launches``: {shape: {kernel: count}}."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import mog_field as mf

    rows = []
    for name, (planes, pd, pix) in k1_shape_inputs(device, config5).items():
        b, c = planes[0].shape
        g = torch.ones(b, dtype=torch.float32, device=device)
        ms = {"K1-fwd": graph_ms(lambda: mf.loglik_fwd_cuda(*planes, *pd, centered=True)),
              "K1-bwd": graph_ms(lambda: mf.loglik_bwd_cuda(*planes, *pd, g))}
        bounds = k1_bounds(b, c, pix, pd[0].shape[1])
        for kernel in ("K1-fwd", "K1-bwd"):
            n = launches[name][kernel]
            bound_ms, bound_by = bounds[kernel]
            rows.append({"kernel": kernel, "shape": name, "chains": b, "components": c,
                         "pixels": pix, "pixels_padded": pd[0].shape[1],
                         "cb_t": list(mf.k1_geometry(b, pd[0].shape[1])), "launches": n,
                         "ms": ms[kernel], "bound_ms": bound_ms, "bound_by": bound_by,
                         "lost_s": n * (ms[kernel] - bound_ms) * 1e-3})
    print(f"[timing] K1 by shape (device ms per call: a CUDA graph of 20 calls, best of 3), "
          f"card: {card}", flush=True)
    for r in rows:
        print(f"    {r['kernel']} {r['shape']}: B={r['chains']} C={r['components']} "
              f"P={r['pixels']} ({r['pixels_padded']}) (CB, T)={tuple(r['cb_t'])} "
              f"ms={r['ms']:.6f} bound={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"launches={r['launches']} lost={r['lost_s']:.6f} s", flush=True)
    return rows


def kernel_bounds(config5, sharded5):
    """Each kernel's bound per wrapper call at the shapes it is timed at:
    config 1's 25x25 stamp at B=65536 (625 pixels, padded to 640), config
    5's buckets at B=1024 (the single-device tables for K2-K4, whose bound
    over both buckets is divided by their two launches; the one-rank sharded
    table for K5 and K6).  Terms count the table entries that are not the
    sentinel: the work this run's data needs."""
    from celeste_tpu_torch.model.galaxy import N_GAL

    f4 = 4
    out = k1_bounds(BENCH_CHAINS, 3, 625, 640)
    b = TIMING_CHAINS[0]
    sentinel = config5[3]["scene"].n_sources * N_GAL
    width = (sentinel + 1) * 3
    planes = 6 * b * width * f4

    def sizes(buckets):
        """(terms, entries x chains, tiles, table bytes, column-list bytes) of
        a table's buckets."""
        entries = sum(int((bk.tile_src != sentinel).sum()) for bk in buckets) * 3 * b
        tiles = sum(bk.tile_src.shape[0] for bk in buckets)
        slots = sum(bk.tile_src.numel() for bk in buckets)
        return (entries * 1024, entries, tiles, slots * f4,
                (len(buckets) * (width + 1) + slots * 3) * f4)

    def per_call(n_calls, ms_by):
        return ms_by[0] / n_calls, ms_by[1]

    buckets = config5[3]["tiled_data"].bucket_tables
    terms, entries, tiles, table, cols = sizes(buckets)
    lam, pixels = tiles * b * 1024 * f4, tiles * b * 1024
    fwd = terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM) + pixels * FLOPS_PIXEL_LOGLIK
    out["K2"] = per_call(len(buckets), bound(
        fwd, planes + table + 5 * tiles * 1024 * f4 + tiles * b * f4, terms + pixels))
    out["K3"] = per_call(len(buckets), bound(
        fwd, planes + table + 5 * tiles * 1024 * f4 + tiles * b * f4 + lam, terms + pixels))
    out["K4"] = per_call(len(buckets), bound(
        terms * (FLOPS_TERM_FORM + FLOPS_TERM_MOMENTS) + pixels * FLOPS_PIXEL_GLAM
        + entries * FLOPS_ENTRY_EPILOGUE,
        2 * planes + table + 4 * tiles * 1024 * f4 + lam + b * f4 + cols, terms))
    buckets = sharded5["loglik"].buckets
    terms, entries, tiles, table, cols = sizes(buckets)
    lam = tiles * b * 1024 * f4
    out["K5"] = per_call(len(buckets), bound(
        terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM), planes + table + 2 * tiles * 1024 * f4 + lam,
        terms))
    out["K6"] = per_call(len(buckets), bound(
        terms * (FLOPS_TERM_FORM + FLOPS_TERM_MOMENTS) + entries * FLOPS_ENTRY_EPILOGUE,
        2 * planes + table + 2 * tiles * 1024 * f4 + lam + cols, terms))
    # K7 on config 5's field with the dense planes (12 sources: 10 stars of
    # 3 components, 2 galaxies of 48) at B=1024: a term's form and sum, and
    # the [B, P] store
    out["K7"] = k7_bound(b, 10 * 3 + 2 * 48, 48 * 128, 48 * 128)
    # K8 on config 1's 25x25 stamp at B=65536: the C (H + W) factors, then per
    # pixel C multiply-adds and the Poisson term (forward) or its cotangent
    # and the two contractions (backward), then the factors' cotangent sums
    b, c, h, w = BENCH_CHAINS, 3, 25, 25
    factors = c * (h + w) * FLOPS_SEP_FACTOR
    pixel_arrays = (h + w + 3 * h * w) * f4
    out["K8-fwd"] = bound(b * (factors + h * w * (c * FLOPS_SEP_TERM + FLOPS_PIXEL_LOGLIK)),
                          4 * b * c * f4 + pixel_arrays + b * f4, b * (c * (h + w) + h * w))
    out["K8-bwd"] = bound(b * (factors + h * w * (c * (FLOPS_SEP_TERM + FLOPS_SEP_CONTRACT)
                                                  + FLOPS_PIXEL_GLAM)
                               + c * (h + w) * FLOPS_SEP_FACTOR_COT),
                          8 * b * c * f4 + pixel_arrays + b * f4, b * c * (h + w))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from celeste_tpu_torch.bench.config5 import build_config5, build_config5_sharded
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import mog_field_sep as ms
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.kernels._build import build_library
    from celeste_tpu_torch.parallel import process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    # one nvcc per library, started together; the loads then find them built
    with ThreadPoolExecutor(max_workers=3) as pool:
        list(pool.map(build_library, ("mog_field", "tiled_field", "mog_field_sep"),
                      (mf._SOURCES, tf._SOURCES, ms._SOURCES)))
    libs = [mf.build_kernels(), tf.build_kernels(), ms.build_kernels()]
    print(f"[build] {', '.join(lib.name for lib in libs)} built and loaded in "
          f"{time.perf_counter() - t_start:.3f} s", flush=True)

    k1_errs = stamp_kernel_checks(device)
    config5 = build_config5(device=device)
    tiled_errs = tiled_kernel_checks(device, config5)
    render_errs = render_kernel_checks(device, build_config5_sharded(config5[3], None))
    k7_err = stamp_render_checks(device, config5)
    k8_errs = sep_kernel_checks(device)
    oracle_checks(device, config5)
    dense_gradient_check(device, config5)
    oracle_checks_23(device)

    mf.reset_launch_counts()
    runs = config1_path(device)
    k1_counts = mf.launch_counts()
    for sampler, cfg, res, seconds, after in runs:
        report_config1(sampler, cfg, res, seconds, after)
    check(runs[0][4]["mog_field_loglik_fwd"] > 0, "MH run never launched the forward kernel")
    for name in ("mog_field_loglik_fwd", "mog_field_loglik_bwd"):
        check(k1_counts[name] > 0, f"the config-1 path never launched {name}")

    mf.reset_launch_counts()
    tf.reset_launch_counts()
    dense_counts = config5_path(device)
    c5_counts = tf.launch_counts()
    print(f"[config 5] launches: {c5_counts} (stamp kernels: {mf.launch_counts()})", flush=True)
    for name in ("tiled_field_fwd", "tiled_field_fwd_lam", "tiled_field_bwd"):
        check(c5_counts[name] > 0, f"the config-5 path never launched {name}")

    mf.reset_launch_counts()
    tf.reset_launch_counts()
    multiband, mb_per_grad = multiband_path(device)
    mb_counts = tf.launch_counts()
    print(f"[config 5 gri] launches: {mb_counts} (stamp kernels: {mf.launch_counts()})",
          flush=True)
    for name in ("tiled_field_fwd", "tiled_field_fwd_lam", "tiled_field_bwd"):
        check(mb_counts[name] > 0, f"the three-band config-5 path never launched {name}")

    runs23 = configs23_path(device)
    k7_launches, k7_shapes = ppc_path(device, runs23)
    k8_counts, k1_65536 = sep_entry_path(device)
    k1_launches = {"config 1": k1_counts, "config 5 dense": dense_counts, "B=65536": k1_65536,
                   "config 2": {k: runs23["ugriz hmc"][3][k] + runs23["ugriz slice"][3][k]
                                for k in k1_counts},
                   "config 3": runs23["galaxy nuts"][3]}
    k1_launches = {shape: {"K1-fwd": c["mog_field_loglik_fwd"], "K1-bwd": c["mog_field_loglik_bwd"]}
                   for shape, c in k1_launches.items()}

    with process_group("nccl"):
        mf.reset_launch_counts()
        tf.reset_launch_counts()
        sharded5, world1 = sharded_path(device, config5)
        sh_counts = tf.launch_counts()
        print(f"[sharded] launches: {sh_counts} (stamp kernels: {mf.launch_counts()})",
              flush=True)
        for name in ("tiled_field_render", "tiled_field_render_bwd"):
            check(sh_counts[name] > 0, f"the sharded config-5 path never launched {name}")
        sharded_world2(world1)

        t1 = config1_timings(device, card)
        t5 = config5_timings(device, card, config5)
        multiband_timings(device, card, multiband)
        tr = render_timings(card, sharded5, t5["vg_ms"])
        t8 = sep_timings(device, card)
        t7 = stamp_render_timings(device, card, config5)
        k7_rows = k7_shape_timings(card, k7_shapes)
        k1_rows = k1_shape_timings(device, card, config5, k1_launches)
        bounds = kernel_bounds(config5, sharded5)
    tiled = "celeste_tpu/kernels/tiled_field.py"
    t5b, trb = t5[TIMING_CHAINS[0]], tr[TIMING_CHAINS[0]]
    rows = [
        ("mog_field_loglik_fwd", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:80", "K1-fwd",
         k1_counts["mog_field_loglik_fwd"], k1_errs["fwd"], t1["fwd_ms"], t1["fwd_plain_ms"]),
        ("mog_field_loglik_bwd", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:182",
         "K1-bwd", k1_counts["mog_field_loglik_bwd"], k1_errs["bwd"], t1["bwd_ms"],
         t1["bwd_plain_ms"]),
        ("tiled_field_fwd", "tiled_field.cu", f"{tiled}:57", "K2",
         c5_counts["tiled_field_fwd"] + mb_counts["tiled_field_fwd"], tiled_errs["K2"],
         t5b["K2"], t5b["K2_plain"]),
        ("tiled_field_fwd_lam", "tiled_field.cu", f"{tiled}:84", "K3",
         c5_counts["tiled_field_fwd_lam"] + mb_counts["tiled_field_fwd_lam"], tiled_errs["K3"],
         t5b["K3"], t5b["K3_plain"]),
        ("tiled_field_bwd", "tiled_field.cu", f"{tiled}:108", "K4",
         c5_counts["tiled_field_bwd"] + mb_counts["tiled_field_bwd"], tiled_errs["K4"],
         t5b["K4"], t5b["K4_plain"]),
        ("tiled_field_render", "tiled_field.cu", f"{tiled}:632", "K5",
         sh_counts["tiled_field_render"], render_errs["K5"], trb["K5"], trb["K5_plain"]),
        ("tiled_field_render_bwd", "tiled_field.cu", f"{tiled}:652", "K6",
         sh_counts["tiled_field_render_bwd"], render_errs["K6"], trb["K6"], trb["K6_plain"]),
        ("mog_field_render", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:103", "K7",
         k7_launches, k7_err, t7["K7_field_ms"], t7["K7_field_plain_ms"]),
        ("mog_field_sep_fwd", "mog_field_sep.cu", "celeste_tpu/kernels/mog_field_sep.py:71",
         "K8-fwd", k8_counts["mog_field_sep_fwd"], k8_errs["fwd"], t8["K8_fwd_ms"],
         t8["K8_fwd_plain_ms"]),
        ("mog_field_sep_bwd", "mog_field_sep.cu", "celeste_tpu/kernels/mog_field_sep.py:163",
         "K8-bwd", k8_counts["mog_field_sep_bwd"], k8_errs["bwd"], t8["K8_bwd_ms"],
         t8["K8_bwd_plain_ms"]),
    ]
    kernels = []
    for name, src, replaces, key, launches, err, ms, plain_ms in rows:
        bound_ms, bound_by = bounds[key]
        check(bound_ms <= ms, f"{key}: {ms:.6f} ms is under its bound {bound_ms:.6f} ms: the "
                              "bound counts work the kernel does not do")
        kernels.append({"name": name, "route": "cuda", "source": f"celeste_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    stop_children()
    print(f"[done] whole script {time.perf_counter() - t_start:.3f} s", flush=True)
    lost = {k: sum(r["lost_s"] for r in k1_rows if r["kernel"] == k) for k in ("K1-fwd", "K1-bwd")}
    print(json.dumps({"k1_shapes": k1_rows, "k1_lost_s": lost}), flush=True)
    print(json.dumps({"k7_shapes": k7_rows, "k7_lost_s": sum(r["lost_s"] for r in k7_rows)}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
