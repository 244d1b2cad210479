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
4. hold the plane kernels (``csrc/scene_planes.cu``, the forward and its
   hand backward) against their plain version (``scene_planes_blocked`` per
   band, and torch autograd through it) at the benchmark cells' shapes,
   config 5 at 65536 chains in r and at 32768 in g, r, i: the planes' bits
   equal; per state column, the gradient's distance from the plain one in
   float64 at most 4 times the float32 plain version's plus 1e-4 of the
   column's largest magnitude; each kernel twice bitwise; timed beside their bounds
   (bytes) and the plain version, in a ``scene_planes`` JSON line; the prior
   kernels (``csrc/scene_prior.cu``) the same way against
   ``_crowded_logprior`` and its autograd gradient at the same shapes, the
   values rtol 2e-6, atol 1e-4, in a ``scene_prior`` JSON line; then
   hold the tiled kernels (K2, K3, K4) against theirs on config-5 planes at
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
   0 with finite cotangents.  Phase 4c: K2-K6 on tiles past the whole-tile
   staging (the staged path) at B=1024: random problems of 780 (K2, K3 and
   K5 whole, K4 and K6 staged) and 2400 components a tile (C = 48), and
   the densest bucket of the tiled crowded_field of 32 sources (24
   galaxies) and of 48 (32) on 64x64 (891 and 1218), against their plain
   versions at the tolerances above (K4 and K6 on the kernels' lambda;
   crowded fields rtol 5e-4, atol 0.1, random problems rtol 2e-4, atol
   5e-3), one launch a wrapper call, twice bitwise, the two paths bitwise
   equal where both fit; each timed (a CUDA graph of 5 calls) beside its
   plain version and bound;
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
   equal; the pixel-set mode of K1-fwd, K1-bwd and K7 ([S, P] pixel sets,
   row b on set b // R) at the field's shapes (PIXEL_SET_SHAPES: 24x24
   candidate cutouts at R = 1 and 2, 48x48 and 32x32 group cutouts at R = 8
   and 32, padding lanes included) against their plain versions on the
   sets expanded to rows, K1-fwd rtol 2e-6 + atol 0.5, K1-bwd rtol 5e-4 +
   atol 5e-2, K7 rtol 1e-5 + atol 1e-3, twice bitwise;
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
   parity -> ``config5_warmup_and_whiten_cached`` -> ``measure_chees_z`` ->
   ``measure_nuts_z``, then ``run_experiment`` of ``crowded_field`` with
   ``tiled=true n_galaxies=2`` in 4 segments with checkpoints; gates:
   finite samples, ChEES accept >= 0.4, divergence <= 0.05 in both arms,
   max split-R-hat <= 1.1 on the ChEES arm; check the whitening maps on
   the card against float64 on the host; fail on a tiled kernel the run
   never launched.  Phase 8c: ``run_experiment`` of ``crowded_field`` with
   ``tiled=true n_sources=32 n_galaxies=24 shape=64,64`` (256 chains; the
   densest bucket's 891 components a tile on the staged path), ChEES cut
   in steps by ENTRY_CROWDED_LARGE, the tiled counters set to 0 just before
   and read just after: finite samples of the run's shape, K3 and K4
   launched (printed with R-hat, which is not gated).  Phase b, the
   warm-start caches, on fresh files: the
   preparation's first call misses and saves, the second hits (live-probe
   gap printed, < 1 nat; the ensemble bitwise the saved one), and on the
   target shifted by +5 nats the live probe is off by >= 4 nats, so a third
   call would miss; for the ChEES warm state the same miss, hit and a whole
   shifted call that misses (the ChEES arm reads the hit);
   Phase a, checkpoint and resume: ``run_experiment`` of ``star_single``
   with MH (64 chains, 400 steps in 4 segments) and HMC (cut by
   RESUME_HMC), and phase 8's crowded_field ChEES run, each stopped after
   segment 2 and resumed from its checkpoint: ``samples``, ``mean`` and
   ``rhat`` bitwise equal to the unbroken run; K1's (K2-K4's) counters set
   to 0 before, and a kernel never launched fails.  Phase c: config 4,
   ``run_experiment`` of ``quasar_photoz`` at the JAX package's
   configuration (8 systems x 8 temperatures, slice inner, 1500 steps after
   500; QUASAR_ENTRY cuts it): finite z, swap rate > 0.05, a fraction >
   0.3 of z within 0.25 of z_true, the lockstep slice's calls per sweep
   printed.  Phase d: the bench's config-4 batch
   (``run_photo_z_batch_segmented``: 256 targets, 6 temperatures,
   hmc_adaptive, 150 + 400 steps in segments of 100, the 8192-point grid):
   z-recovery >= 0.88, full-wall and steady targets/s printed;
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
   just before), against the general kernel.  Phase f, the stamp pipeline:
   ``run_experiment`` of ``pipeline`` with ``ppc=true``, its sampler cut in
   steps by PIPELINE_ENTRY
   (a 33x33 r-band stamp with two stars and a galaxy; detection, three
   classify sweeps of 300-step MAP fits with Laplace evidence, the type
   switch, 16 chains of dense-metric ChEES with 100 warmup and 200 steps,
   the catalog, the PPC), every counter set to 0 just before and read just
   after, K1's and K7's launches printed per stage and per classify Adam
   step and counted by shape; gates: 3 sources, kinds [galaxy, star, star],
   catalog completeness, purity and kind accuracy 1.0, position RMS < 0.2
   arcsec, |flux bias| < 0.2, PPC p in (0.01, 0.99), max R-hat <= 1.1, each
   sweep one K1-fwd and one K1-bwd launch per Adam step (two more forwards
   and one backward for its Hessians and source-free evidences), the same
   at 1, 3 and 6 candidates in a 10-step sweep.  Phase g, the field
   catalog pipeline, every counter set to 0 just before each run and read
   just after, K1's and K7's launches printed per stage (detection rounds,
   classify sweeps, the type switch, the group sampler) and counted by
   shape: ``run_experiment`` of ``field`` as the config has it (96x96, 5
   sources, 32 chains, 100 + 300 steps, ``FieldConfig`` defaults, the type
   switch on), gates those of tests/test_field.py's detection and grouping
   tests (5 sources, kinds 4 stars and a galaxy, each within 0.5 arcsec of
   a distinct truth, 4 groups with s_max 2, the pair a star and the
   galaxy) and every group's max R-hat < 1.1 and divergence < 0.05; then
   ``field_survey`` as its config has it (256x1024, ~60 sources, 8 chains,
   48 + 96 steps, sampled): completeness, purity and kind accuracy >= 0.9,
   matches >= 0.9 of the sources, position RMS < 0.1 arcsec, |flux bias| <
   0.05, position and flux z-RMS in [0.7, 1.4], the groups' R-hat and
   divergence as ``field``'s; each classify sweep one K1-fwd and one
   K1-bwd launch per Adam step (plus its Hessian batch) at any candidate
   count; then the field's checkpoint and resume on ``field``'s frame at
   FIELD_RESUME (tests/test_field.py's resume test's cut): a run stopped
   after its first sampling segment and resumed equals the unbroken one
   bitwise; then K1-fwd, K1-bwd and K7 on rows of LARGE_C = 400, 960 and
   2400 components (past the whole-row staging: the staged path) in the
   stamp mode at B = 64 and 1024 on 48x48 and on field_survey's and
   field's group pixel sets, against their plain versions at the
   tolerances above, one launch a call, twice bitwise, the staged and
   whole-row paths bitwise equal where both fit, timed at 960 and 2400;
   and the field's group log density of a galaxy cluster linked into one
   group of 20 sources (960 components a row) at 32 chains through K1,
   value and gradient against the CPU's plain mode;
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
   at the same tolerances, and ``dryrun_multichip(1)`` runs (the field's
   group shard and its tempering
   part: the ladder sharded over the ranks, two steps, finite logps).
   Phase e: the tempering ladder sharded over a ``temps`` mesh, on one NCCL
   rank in this process and on two spawned gloo ranks on the one card,
   against the in-device ladder on the bimodal 2-D target (8 temperatures,
   20 steps): xs rtol 1e-5, atol 1e-5, logps rtol 1e-4, atol 1e-4, every
   swap decision equal; ``run_photo_z_sharded`` (hmc_adaptive) against
   ``run_photo_z``, vec rtol 2e-4, atol 2e-5;
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
   this run's launches at that shape; K1 and K7 at every shape the pipeline
   launched them, on its inputs there, held against their plain versions
   (K1-fwd rtol 2e-6, atol 1.0, K1-bwd rtol 5e-4, atol 5e-2, K7 rtol 1e-5,
   atol 1e-3) and timed likewise, and so where the field's two runs launch
   them (their pixel sets expanded to rows for the plain versions); the
   pixel-set mode at PIXEL_SET_SHAPES, kernel and plain;
13. print K1's rows by shape as a JSON line (``k1_shapes``, with the time
    lost, launches x (ms - bound), summed per kernel in ``k1_lost_s``), K7's
    likewise (``k7_shapes``, ``k7_lost_s``), the rows of many components
    (``large_c``; no main-path run launches them), the tiled kernels' rows
    past the whole-tile staging (``large_tile``, the 32-source field's with
    phase 8c's launches on each bucket and their time lost), then the
    kernels' JSON line
    (K1-fwd, K1-bwd, K2-K7, K8-fwd, K8-bwd, the plane and prior kernels at
    config 5's 65536 chains in r, and K1-fwd, K1-bwd and K7 in
    the pixel-set mode: the field runs' launches, timed at the ``field``
    group sampler's shape [128, 96] x 4 sets of 2304 pixels and at the
    candidate cutouts' [16, 48] x 16 sets of 576), each kernel's ms per wrapper
    call (K2-K4: both buckets timed together, divided by their two
    launches; their launches those of both config-5 paths, one band and
    three and of phase 8c; K1's those of config 1's path and the
    pipeline's, K7's those of
    the PPC and the pipeline) with its bound per call (the largest of its bytes over the
    card's memory rate, its float32 operations over the card's float32
    rate, and its exponentials and logarithms over the special-function
    unit's rate), failing on a kernel faster than its
    bound, then the card line and the result line.

Before its last lines, and on any failure, the script stops every process
it started that still runs (the resource tracker that the spawned ranks'
queues start, and any other child).

The samplers of phases 7-11 are cut in steps only (chains, bands, sources
and fields stay at their width), by the constants below (PERF.md lists
them), so that the script fits its time on a slow host: every sampler is
bound by the host's ~20 us an op, not by the card.  Phase g's field runs
stay as their configs have them.  Each phase's wall is printed as a
``[wall]`` line.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import signal
import subprocess
import sys
import tempfile
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
# phase 4c: K2-K6 on tiles past the whole-tile staging (the staged path),
# at B = 1024: random problems of 260 slots of 3 components (780 a tile: K2,
# K3 and K5 stage it whole, K4 and K6 staged) and of 50 slots of 48 (2400),
# and the tiled crowded_field of 32 sources (24 galaxies) and of 48 (32) on
# 64x64, whose densest buckets hold 891 and 1218 components a tile; each
# case's densest bucket checked and timed
LARGE_TILE_CHAINS = 1024
LARGE_TILE_RANDOM = ((260, 3), (50, 48))
LARGE_TILE_FIELDS = ((32, 24, (64, 64)), (48, 32, (64, 64)))
TILED_COUNTERS = {"K2": "tiled_field_fwd", "K3": "tiled_field_fwd_lam", "K4": "tiled_field_bwd",
                  "K5": "tiled_field_render", "K6": "tiled_field_render_bwd"}
TIMING_CHAINS = (1024, 4096)   # the config-5 kernel timings
# the entry point's crowded_field run (defaults: 300 warmup, 500 steps, 16
# leapfrog, depth 6), in 4 segments with checkpoints: phase a's unbroken
# ChEES run (its trajectories capped at 4 n_leapfrog)
ENTRY_CROWDED = dict(n_warmup=16, n_steps=16, n_leapfrog=2, max_depth=4, checkpoint_every=4)
# phase 8c: crowded_field past the whole-tile staging through the entry
# point (32 sources, 24 of them galaxies, 64x64, the config's 256 chains),
# its sampler cut in steps (the config: 300 warmup, 500 steps, 16 leapfrog,
# depth 6; ChEES adapts over at least 100 iterations whatever the warmup)
ENTRY_CROWDED_LARGE = dict(tiled=True, n_sources=32, n_galaxies=24, shape=(64, 64), n_warmup=10,
                           n_steps=10, n_leapfrog=1, max_depth=2)
# phase a: star_single MH as configured (64 chains) and HMC cut in steps (the
# config: 300 warmup, 500 steps, 16 leapfrog), each in 4 segments
RESUME_MH = dict(n_steps=400, checkpoint_every=100)
RESUME_HMC = dict(sampler="hmc", n_warmup=100, n_steps=100, n_leapfrog=8, checkpoint_every=25)
# config 5's preparation and ChEES arm, cut in steps (the bench's defaults,
# bench/config5.py: HMC warmup 150, probe 16, z-space warmup 30; ChEES
# warmup 60, 240 steps in segments of 48): the three-band flow's counts
C5_PREP = dict(n_warmup=50, warmup_window=50, probe_steps=4, n_zwarm=10)
C5_CHEES_WARMUP = 20            # config 5's ChEES adaptation (measure_chees_z's)
C5_CHEES = dict(warmup_iters=C5_CHEES_WARMUP, n_steps=48, run_segment=48)
# phase c: config 4 through run_experiment (the config: 8 systems x 8
# temperatures, 1500 steps after 500 of warmup), cut in steps only
QUASAR_ENTRY = dict(n_steps=160, n_warmup=60)
PHOTOZ_TARGETS = 256            # phase d: the bench's photo-z batch
LADDER_TEMPS, LADDER_STEPS = 8, 20   # phase e: the bimodal ladder
# config 5's NUTS arm (the JAX bench: 64 steps in segments of 16)
C5_NUTS = dict(n_steps=8, run_segment=8)
# config 5 in three bands (g, r, i), cut in steps only (chains, bands,
# sources and field as the JAX bench has them), against the JAX bench's
# stage (bench.py _bench_config5_multiband): HMC warmup 150 in windows of 50
# from a step of 0.03, NUTS probe 16, z-space warmup 30; ChEES warmup 60 in
# windows of 20, 192 steps in segments of 48
MULTIBAND_PREP = dict(n_warmup=50, warmup_window=50, init_step_size=0.03, probe_steps=4,
                      n_zwarm=10)
MULTIBAND_CHEES = dict(warmup_iters=20, warmup_window=20, n_steps=24, run_segment=24)
MULTIBAND_ARTIFACTS = ("config5_multiband_prep", "config5_multiband_chees_prep")
# config 1's HMC run (the config: 300 warmup, 500 steps)
STAR_HMC = dict(n_steps=100, n_warmup=300)
# the sharded ChEES run on config 5's rectangular posterior (the JAX
# helper's defaults: 100 warmup, 400 steps, trajectory cap 256)
SHARDED_CHEES = dict(n_warmup=100, n_steps=40, max_leapfrog=32)
# configs 2 and 3 through the entry point, cut in steps only (chains, bands
# and stamps as the configs have them): star_ugriz HMC (JAX defaults: 300
# warmup, 1000 steps) and slice (1000 sweeps); galaxy NUTS (300 warmup, 800
# steps)
UGRIZ_HMC = dict(n_warmup=300, n_steps=75)
UGRIZ_SLICE = dict(n_steps=50)
GALAXY_NUTS = dict(n_warmup=150, n_steps=75)
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
# phase f: the stamp pipeline through run_experiment with the PPC, its
# sampler cut in steps (the config: 16 chains, 200 warmup, 400 ChEES steps;
# the type switch's 300 steps of 8 chains and the 300-step MAP fits as they
# are); max R-hat at the entry runs' gate; then classify sweeps of 10 Adam
# steps at 1, 3 and 6 candidates
PIPELINE_ENTRY = dict(ppc=True, n_warmup=100, n_steps=200)
PIPELINE_RHAT = 1.1
PIPELINE_SWEEP_N, PIPELINE_SWEEP_STEPS = (1, 3, 6), 10
# phase g: the pixel-set mode at the field's shapes (name, sets, rows per
# set, components, cutout side): the detection MAPs' and the classify
# batch's candidate cutouts (a galaxy-wide row, 48 components, as
# mixed_field_planes gives it), and the groups' cutouts at R = 8 and 32
# chains with two and three galaxy-wide slots
PIXEL_SET_SHAPES = (("cutout R=1", 16, 1, 48, 24), ("cutout R=2", 16, 2, 48, 24),
                    ("group 48x48 R=8", 4, 8, 96, 48), ("group 48x48 R=32", 4, 32, 96, 48),
                    ("group 32x32 R=8", 53, 8, 144, 32), ("group 32x32 R=32", 4, 32, 144, 32))
FIELD_RHAT, FIELD_DIVERGENCE = 1.1, 0.05
# phase g: K1 and K7 on rows of many components (the staged path past the
# whole-row staging): 400 (K1-bwd's whole-row limit at 8 chains a block), a
# field group of 20 sources (960) and of 50 (2400), in the stamp mode at B =
# 64 and 1024 on 48x48 and on the field's group pixel sets (field_survey's
# [424, C] x 53 sets of 32x32, field's [128, C] x 4 of 48x48); timed at
# LARGE_C_TIMED
LARGE_C = (400, 960, 2400)
LARGE_C_TIMED = (960, 2400)
LARGE_C_LAYOUTS = (("stamp B=64 48x48", 1, 64, 48), ("stamp B=1024 48x48", 1, 1024, 48),
                   ("field_survey groups", 53, 8, 32), ("field groups", 4, 32, 48))
# the field's resume check, at the cut of tests/test_field.py's resume test
FIELD_RESUME = dict(n_chains=8, probe_warmup=20, probe_steps=8, n_warmup=20, n_steps=20,
                    map_steps=60, sample_segment=8, warmup_window=9, type_switch=False,
                    group_cut=32, group_margin_px=8, seed=4)
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


def once_ms(fn):
    """(fn(), ms of that one call), timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


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


# the plane kernels at the benchmark cells' shapes: (name, chains, bands)
SCENE_PLANES_SHAPES = (("c5_r", 65536, 1), ("c5_gri", 32768, 3))


def scene_planes_bounds(prep, b):
    """The plane kernels' bounds in ms at ``b`` chains, bytes over the HBM
    rate (their FP32 work, ~30 operations and two special functions a
    column, is far below it): the forward reads the states and writes every
    band's six planes once; the backward reads the states and the live
    columns' six cotangents of every band and writes the gradient once."""
    f4, n_pb = 4, len(prep.bands)
    live = sum(prep.src_w if kind == "galaxy" else prep.n_comp for kind in prep.scene.kinds)
    states = b * prep.d_total * f4
    fwd = states + n_pb * 6 * b * prep.plane_w * f4
    bwd = 2 * states + n_pb * 6 * b * live * f4
    return fwd / HBM_BYTES_PER_S * 1e3, bwd / HBM_BYTES_PER_S * 1e3


def scene_planes_checks(device, card, config5):
    """The plane kernels against their plain version at SCENE_PLANES_SHAPES
    (config 5's truth plus noise of 0.01): the planes, the gradient of
    random cotangents, two calls of each kernel bitwise; then each timed
    (best of 3 runs of 20 calls) beside its bound and the plain version (the
    plain backward's time is that of the plain forward and its autograd
    backward, less the forward's).  Prints and returns the rows."""
    from celeste_tpu_torch.bench.config5 import build_config5_multiband
    from celeste_tpu_torch.kernels import scene_planes as sp

    builds = {1: config5, 3: build_config5_multiband(device=device)}
    rows = []
    for name, b, nb in SCENE_PLANES_SHAPES:
        _, _, vec, info = builds[nb]
        stamps = info["stamps"] if nb > 1 else [info["stamp"]]
        prep = sp.ScenePlanes(info["scene"], stamps, range(nb))
        gen = torch.Generator(device=device).manual_seed(17)
        vecs = vec[None] + 0.01 * torch.randn(b, vec.shape[0], generator=gen, device=device)

        got, want = sp.scene_planes_fwd_cuda(prep, vecs), prep.plain(vecs)
        check(all(torch.equal(got[q, i], want[q][i]) for q in range(nb) for i in range(6)),
              f"{name}: the plane forward's bits differ from the plain version's")
        err_fwd = 0.0
        cots = [torch.randn(b, prep.plane_w, generator=gen, device=device)
                for _ in range(6 * nb)]
        grad = sp.scene_planes_bwd_cuda(prep, vecs, cots)
        x = vecs.clone().requires_grad_(True)

        def plain_vjp(x=x, cots=cots):
            return torch.autograd.grad([p for band in prep.plain(x) for p in band], x, cots)[0]

        want_g = plain_vjp()
        ref = plain_vjp(vecs.double().requires_grad_(True), [c.double() for c in cots])
        err_g = (grad.double() - ref).abs().amax(dim=0)
        bound = (4.0 * (want_g.double() - ref).abs().amax(dim=0)
                 + 1e-4 * ref.abs().amax(dim=0))
        check(bool((err_g <= bound).all()),
              f"{name}: the plane backward is off the plain gradient by {float(err_g.max()):.4g}")
        err_g = float((grad - want_g).abs().max())
        del ref
        check(torch.equal(got, sp.scene_planes_fwd_cuda(prep, vecs)),
              f"{name}: two forward calls differ")
        check(torch.equal(grad, sp.scene_planes_bwd_cuda(prep, vecs, cots)),
              f"{name}: two backward calls differ")
        fwd_bound, bwd_bound = scene_planes_bounds(prep, b)
        fwd_ms = time_ms(lambda: sp.scene_planes_fwd_cuda(prep, vecs), 20)
        bwd_ms = time_ms(lambda: sp.scene_planes_bwd_cuda(prep, vecs, cots), 20)
        plain_fwd_ms = time_ms(lambda: prep.plain(vecs), 3)
        plain_vjp_ms = time_ms(plain_vjp, 3)
        for kernel, ms, bound_ms, plain_ms, err in (
                ("planes-fwd", fwd_ms, fwd_bound, plain_fwd_ms, err_fwd),
                ("planes-bwd", bwd_ms, bwd_bound, plain_vjp_ms - plain_fwd_ms, err_g)):
            check(bound_ms <= ms, f"{name} {kernel}: {ms:.6f} ms under its bound {bound_ms:.6f}")
            rows.append({"kernel": kernel, "shape": name, "chains": b, "bands": nb,
                         "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                         "plain_ms": plain_ms, "max_abs_err": err, "card": card})
            print(f"[kernels] {kernel} {name} B={b}: {ms:.6f} ms, bound {bound_ms:.6f} ms "
                  f"(bytes), plain {plain_ms:.6f} ms, max abs err {err:.4g}", flush=True)
        del got, want, grad, cots, x, want_g
        torch.cuda.empty_cache()
    print(json.dumps({"scene_planes": rows}), flush=True)
    return rows


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


@contextlib.contextmanager
def forced_tile_path(staged):
    """The tiled kernels' wrappers take the staged (or the whole-tile) path
    at any tile."""
    from celeste_tpu_torch.kernels import tiled_field as tf

    real = tf.tile_staged
    tf.tile_staged = lambda kernel, n_k: staged
    try:
        yield
    finally:
        tf.tile_staged = real


def large_tile_cases(device, b):
    """Phase 4c's problems at ``b`` chains: (name, buckets, planes, sentinel
    slot, components a slot, K4's and K6's tolerance) for the random
    problems of LARGE_TILE_RANDOM (RANDOM_BWD_TOL) and the crowded fields
    of LARGE_TILE_FIELDS (TILED_BWD_TOL)."""
    from celeste_tpu_torch.bench.tiled_turns import crowded_tiles, random_tiles

    cases = [(f"random {s * c}", *random_tiles(s, c, b, device, seed=s), RANDOM_BWD_TOL)
             for s, c in LARGE_TILE_RANDOM]
    cases += [(f"crowded_field {n}/{ng} {h}x{w}", *crowded_tiles(n, ng, (h, w), b, device),
               TILED_BWD_TOL) for n, ng, (h, w) in LARGE_TILE_FIELDS]
    return cases


def large_tile_checks(device, card):
    """Phase 4c: K2-K6 on tiles past the whole-tile staging, the densest
    bucket of each of large_tile_cases at LARGE_TILE_CHAINS (the card tests
    take every bucket): K2 and K3's log-likelihood
    rtol 2e-6, atol 1.0, K3's and K5's lambda rtol 1e-5, atol 1e-3, K4 and
    K6 against their plain versions on the kernels' own lambda (crowded
    fields rtol 5e-4, atol 0.1; random problems rtol 2e-4, atol 5e-3); one
    launch a wrapper call; two calls bitwise equal; where the other path
    also fits, it gives the same bits.  Each timed: device ms per call (a
    CUDA graph of 5 calls, best of 3), the plain version's (one call, CUDA
    events), the bound.  Returns the rows."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import tiled_field as tf

    b = LARGE_TILE_CHAINS
    rng = np.random.default_rng(b)
    g = torch.as_tensor(rng.normal(size=b).astype(np.float32), device=device)
    kinds = {"K2": "fwd", "K3": "fwd", "K4": "bwd", "K5": "render", "K6": "bwd"}
    rows = []
    for name, buckets, planes, sentinel, c, bwd_tol in large_tile_cases(device, b):
        i = max(range(len(buckets)), key=lambda j: buckets[j].s_cap)
        bk = buckets[i]
        n_k, n_tiles = bk.s_cap * c, bk.tile_src.shape[0]
        px, py = bk.pixels[:2]
        cols = bk.columns(c, planes[0].shape[1])
        g_r = torch.as_tensor(rng.normal(size=(n_tiles, b, 1024)).astype(np.float32),
                              device=device)
        (want_ll, want_lam), plain_ms = once_ms(
            lambda: tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, c))
        lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c)[1]
        calls = {
            "K2": lambda: (tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c),),
            "K3": lambda: tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c),
            "K4": lambda: tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols,
                                            n_comp=c),
            "K5": lambda: (tf.tiled_render_cuda(*planes, bk.tile_src, px, py, n_comp=c),),
            "K6": lambda: tf.tiled_render_bwd_cuda(*planes, bk.tile_src, px, py, g_r, *cols,
                                                   n_comp=c)}
        plains = {
            "K2": lambda: tf._tiled_torch(planes, bk.tile_src, bk.pixels, c),
            "K4": lambda: tf._tiled_bwd_torch(planes, bk.tile_src, bk.pixels, lam, g, c),
            "K5": lambda: tf._tiled_render_torch(planes, bk.tile_src, px, py, c),
            "K6": lambda: tf._tiled_render_bwd_torch(planes, bk.tile_src, px, py, g_r, c)}
        bounds = tiled_bounds([bk], sentinel, c, b)
        for kernel, fn in calls.items():
            what = f"large tile {name} bucket {i} {kernel} B={b} K={n_k}"
            before = tf.launch_counts()[TILED_COUNTERS[kernel]]
            got = [t.clone() for t in fn()]
            check(tf.launch_counts()[TILED_COUNTERS[kernel]] == before + 1,
                  f"{what}: not one launch")
            check(all(torch.equal(x, y) for x, y in zip(got, fn())),
                  f"{what}: not bitwise repeatable")
            staged = tf.tile_staged(kinds[kernel], n_k)
            both = tf.tile_smem_bytes(kinds[kernel], n_k) <= tf.SMEM_OPTIN
            if both:
                with forced_tile_path(not staged):
                    other = fn()
                check(all(torch.equal(x, y) for x, y in zip(got, other)),
                      f"{what}: the staged and whole-tile paths differ")
            if kernel == "K3":
                want, k_ms = (want_ll, want_lam), plain_ms
            else:
                want, k_ms = once_ms(plains[kernel])
                want = want if isinstance(want, tuple) else (want,)
            if kernel in ("K2", "K3"):
                err = max_abs_err(got[0], want[0], *TILED_TOL, what)
                if kernel == "K3":
                    max_abs_err(got[1], want[1], *LAM_TOL, what + " lambda")
            elif kernel == "K5":
                err = max_abs_err(got[0], want[0], *LAM_TOL, what)
            else:
                err = max(max_abs_err(x, w, *bwd_tol, f"{what} d_{p}")
                          for x, w, p in zip(got, want, ("amp", "mx", "my", "pa", "pb", "pc")))
            row = {"kernel": kernel, "shape": f"{name} bucket {i}", "chains": b,
                   "components": n_k, "tiles": n_tiles, "buckets": len(buckets),
                   "staged": staged,
                   "both_paths_bitwise": both, "max_abs_err": err, "launches": 0,
                   "ms": graph_ms(fn, reps=5), "plain_ms": k_ms, "lost_s": 0.0}
            row["bound_ms"], row["bound_by"] = bounds[kernel]
            check(row["bound_ms"] <= row["ms"], f"{what}: under its bound")
            rows.append(row)
    print(f"[large tile] K2-K6 at {sorted({r['components'] for r in rows})} components a tile "
          f"(B={b}) match their plain versions, one launch a call, bitwise repeatable, staged "
          f"== whole-tile where both fit ({card})", flush=True)
    for r in rows:
        print(f"    {r['kernel']} {r['shape']}: K={r['components']} T={r['tiles']} "
              f"staged={r['staged']} ms={r['ms']:.6f} plain={r['plain_ms']:.6f} "
              f"bound={r['bound_ms']:.6f} ({r['bound_by']}) max abs err "
              f"{r['max_abs_err']:.4g}", flush=True)
    return rows


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


def config5_path(device, tmp):
    """Phase 8: config 5 at full width, its preparation and ChEES warm state
    behind fresh cache files (phase b), then crowded_field through the entry
    point in segments with checkpoints (phase a's unbroken run).  Returns
    the stamp kernels' counts after the dense parity probe and the entry
    run's result."""
    from celeste_tpu_torch.bench.config5 import (
        build_config5, config5_parity_gap, measure_chees_z, measure_nuts_z,
    )
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import mog_field as mf

    t0 = time.perf_counter()
    logd, logd_dense, vec, info = build_config5(device=device)
    gap, _ = config5_parity_gap(logd, logd_dense, vec)
    dense_counts = mf.launch_counts()    # the dense probe's K1 calls (8 chains)
    check(gap < 1.0, f"config-5 parity gap {gap:.4g} nats >= 1")
    prep = cached_prep(logd, vec, tmp)
    t_prep = time.perf_counter() - t0
    chees_cache, chees_saved = cached_chees_warm(prep, tmp)
    chees = measure_chees_z(prep, warm_cache_path=chees_cache, **C5_CHEES)
    chees_cache_shift_miss(prep, chees_cache, chees_saved)
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
    cfg.out = f"{tmp}/chees_full"
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
    return dense_counts, res


def crowded_large_path(device):
    """Phase 8c: ``run_experiment`` of ``crowded_field`` past the whole-tile
    staging (ENTRY_CROWDED_LARGE: 32 sources, 24 galaxies, 64x64, 256
    chains, ChEES cut in steps), the tiled counters set to 0 just before and
    read just after: the densest bucket's 891 components a tile take the
    staged path; finite samples of the run's shape; K3 and K4 launched.
    R-hat printed, not gated.  Returns the run's launches."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import tiled_field as tf

    cfg = copy.deepcopy(CONFIGS["crowded_field"])
    cfg.device = str(device)
    for k, v in ENTRY_CROWDED_LARGE.items():
        setattr(cfg, k, v)
    check(all(tf.tile_staged(k, 891) for k in ("fwd", "render", "bwd")),
          "891 components a tile would not take the staged path")
    tf.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tf.launch_counts()
    n_gal = cfg.n_galaxies
    d = n_gal * 7 + (cfg.n_sources - n_gal) * 3
    check(res["samples"].shape == (cfg.n_chains, cfg.n_steps, d),
          f"crowded_field (32 sources) samples shape {res['samples'].shape}")
    check(bool(np.isfinite(res["samples"]).all()), "crowded_field (32 sources): non-finite samples")
    print(f"[entry] run_experiment crowded_field tiled=true n_sources={cfg.n_sources} "
          f"n_galaxies={n_gal} shape={cfg.shape} chains={cfg.n_chains} warmup={cfg.n_warmup} "
          f"steps={cfg.n_steps} n_leapfrog={cfg.n_leapfrog} max_depth={cfg.max_depth}: "
          f"wall={wall:.3f}s accept={res['accept_rate']:.4f} "
          f"divergence={res['divergence_rate']:.4f} eps={res['step_size']:.4f} "
          f"traj={res['trajectory_length']:.4f} max_rhat={float(np.max(res['rhat'])):.4f} "
          f"(printed, not gated) min_ess={float(np.min(res['ess'])):.1f} K3 launches "
          f"{counts['tiled_field_fwd_lam']}, K4 launches {counts['tiled_field_bwd']} "
          f"(all: {counts})", flush=True)
    for name in ("tiled_field_fwd_lam", "tiled_field_bwd"):
        check(counts[name] > 0, f"the 32-source crowded_field run never launched {name}")
    return counts


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
# the stamp pipeline (phase f)
# ---------------------------------------------------------------------------

class ShapeLaunches:
    """K1's and K7's launches by shape inside a ``with`` block: the wrappers
    of ``kernels.mog_field`` are wrapped so that each call adds, under
    (kernel, chains, components, pixel sets, padded pixels), what it added to the
    wrapper's own launch counter (a call that launched nothing adds 0), and
    the first inputs of a launch at each shape are kept (cloned) to time
    the kernel there afterwards.  ``check_totals`` holds the sums by kernel
    against the counters of the same run."""

    NAMES = (("K1-fwd", "loglik_fwd_cuda", "mog_field_loglik_fwd"),
             ("K1-bwd", "loglik_bwd_cuda", "mog_field_loglik_bwd"),
             ("K7", "render_cuda", "mog_field_render"))

    def __init__(self):
        self.counts, self.inputs = {}, {}

    def _wrap(self, kernel, counter, fn):
        from celeste_tpu_torch.kernels import mog_field as mf

        def call(*args, **kw):
            before = mf.launch_counts()[counter]
            out = fn(*args, **kw)
            n = mf.launch_counts()[counter] - before
            if n:
                key = (kernel, args[0].shape[0], args[0].shape[1], *args[6].shape)
                self.counts[key] = self.counts.get(key, 0) + n
                if key not in self.inputs:
                    self.inputs[key] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                                        kw)
            return out
        return call

    def __enter__(self):
        from celeste_tpu_torch.kernels import mog_field as mf

        self._orig = {attr: getattr(mf, attr) for _, attr, _ in self.NAMES}
        for kernel, attr, counter in self.NAMES:
            setattr(mf, attr, self._wrap(kernel, counter, self._orig[attr]))
        return self

    def __exit__(self, *exc):
        from celeste_tpu_torch.kernels import mog_field as mf

        for _, attr, _ in self.NAMES:
            setattr(mf, attr, self._orig[attr])

    def check_totals(self, counts):
        """Fail unless the launches by shape of each kernel sum to its
        counter's ``counts`` of the same run."""
        for kernel, _, counter in self.NAMES:
            total = sum(n for key, n in self.counts.items() if key[0] == kernel)
            check(total == counts[counter],
                  f"{kernel}: {total} launches by shape, its counter says {counts[counter]}")


def pipeline_sweep_launches(run):
    """One classify sweep of PIPELINE_SWEEP_STEPS Adam steps at each
    candidate count of PIPELINE_SWEEP_N on the pipeline's field (its
    sources at the catalog's MAPs, then stars at the truth's neighbours):
    K1-fwd launches steps + 2 (the Adam steps, one Hessian batch, the
    source-free evidence), K1-bwd steps + 1, whatever the count."""
    from celeste_tpu_torch import pipeline as tpipe
    from celeste_tpu_torch.kernels import mog_field as mf

    scene, catalog = run["scene"], run["catalog"]
    cond = tpipe.Conditional(scene.stamps, [0], 1, run["priors"])
    cfg = tpipe.PipelineConfig(map_steps=PIPELINE_SWEEP_STEPS)
    rng = np.random.default_rng(3)
    out = {}
    for n in PIPELINE_SWEEP_N:
        cand = []
        for i in range(n):
            e = catalog[i % len(catalog)]
            x = np.concatenate([e.du_mean + (0.0 if i < len(catalog) else rng.normal(0, 2, 2)),
                                np.log(e.flux_mean)]).astype(np.float32)
            cand.append({"kind": "star", "x": x, "p": 1.0, "alive": True})
        mf.reset_launch_counts()
        tpipe.classify_sweep(cond, cand, cfg)
        torch.cuda.synchronize()
        c = mf.launch_counts()
        out[n] = (c["mog_field_loglik_fwd"], c["mog_field_loglik_bwd"])
        check(out[n] == (PIPELINE_SWEEP_STEPS + 2, PIPELINE_SWEEP_STEPS + 1),
              f"a classify sweep of {n} candidates launched K1 {out[n]} times, not "
              f"{(PIPELINE_SWEEP_STEPS + 2, PIPELINE_SWEEP_STEPS + 1)}")
    print(f"[pipeline] classify sweep of {PIPELINE_SWEEP_STEPS} Adam steps, K1 (fwd, bwd) "
          f"launches by candidate count: {out}: one of each per Adam step at every count",
          flush=True)


def pipeline_path(device):
    """Phase f: ``run_experiment`` of the ``pipeline`` config with the PPC,
    every counter set to 0 just before and read just after; the launches of
    each stage (the pipeline's stage functions wrapped) and of K1 and K7 by
    shape.  Gates: three sources, kinds [galaxy, star, star], catalog
    completeness, purity and kind accuracy 1.0, position RMS < 0.2 arcsec,
    |flux bias| < 0.2, the PPC p-value in (0.01, 0.99), max R-hat <=
    PIPELINE_RHAT, one K1-fwd and one K1-bwd launch per classify Adam step
    (each sweep: map_steps + 2 and + 1) and K1 and K7 launched.  Returns the
    path's launches, the ``ShapeLaunches`` and the stamp's pixel count."""
    from celeste_tpu_torch import pipeline as tpipe
    from celeste_tpu_torch.catalog import catalog_accuracy, reference_from_sources
    from celeste_tpu_torch.kernels import mog_field as mf

    stages = []

    def staged(name, fn):
        def call(*args, **kw):
            before, t0 = dict(mf.launch_counts()), time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            after = mf.launch_counts()
            stages.append((name, {k: after[k] - before[k] for k in after},
                           time.perf_counter() - t0,
                           len(out) if name == "classify_sweep" else None))
            return out
        return call

    names = ("detect", "classify_sweep", "type_switch_stage", "sample_scene")
    orig = {n: getattr(tpipe, n) for n in names}
    for n in names:
        setattr(tpipe, n, staged(n, orig[n]))
    try:
        with ShapeLaunches() as shapes:
            cfg, res, seconds, counts = entry_run("pipeline", PIPELINE_ENTRY, device)
    finally:
        for n in names:
            setattr(tpipe, n, orig[n])
    run = res["run"]
    catalog, art = run["catalog"], run["artifacts"]
    map_steps = tpipe.PipelineConfig().map_steps
    staged_k7 = 0
    for name, c, secs, n_cand in stages:
        k1 = (c["mog_field_loglik_fwd"], c["mog_field_loglik_bwd"])
        staged_k7 += c["mog_field_render"]
        extra = ""
        if name == "classify_sweep":
            extra = (f" ({n_cand} candidates, {2 * n_cand} rows; per Adam step K1 "
                     f"{(k1[0] - 2) / map_steps:g} fwd, {(k1[1] - 1) / map_steps:g} bwd)")
            check(k1 == (map_steps + 2, map_steps + 1),
                  f"a classify sweep of {n_cand} candidates launched K1 {k1} times, not "
                  f"{(map_steps + 2, map_steps + 1)}")
        print(f"[pipeline] {name}: K1 fwd {k1[0]} bwd {k1[1]}, K7 {c['mog_field_render']}, "
              f"{secs:.3f} s{extra}", flush=True)
    print(f"[pipeline] ppc: K7 {counts['mog_field_render'] - staged_k7}", flush=True)
    summ = art["summary"]
    rhat = float(torch.max(summ["rhat"]))
    ref = reference_from_sources(run["sources"], run["scene"].wcs, band_slots=[2])
    rep = catalog_accuracy(catalog, ref, max_sep_arcsec=1.0)
    pv = float(res["ppc_pvalue"][0])
    print(f"[pipeline] run_experiment pipeline ppc=true: {seconds:.3f} s, chains "
          f"{cfg.n_chains}, warmup {cfg.n_warmup}, steps {cfg.n_steps}; kinds "
          f"{[str(k) for k in res['kinds']]}, p_star {np.round(res['p_star'], 4).tolist()}; "
          f"completeness "
          f"{rep['completeness']}, purity {rep['purity']}, kind accuracy {rep['kind_accuracy']}, "
          f"pos rms {rep['pos_rms_arcsec']:.4f} arcsec, flux bias {rep['flux_rel_bias']:.4f}, "
          f"pos z rms {rep['pos_z_rms']:.3f}, flux z rms {rep['flux_z_rms']:.3f}; PPC p {pv:.4f}; "
          f"max R-hat {rhat:.4f}, min ESS {float(torch.min(summ['ess'])):.1f}; launches {counts}",
          flush=True)
    check(art["n_sources"] == 3, f"pipeline: {art['n_sources']} sources, not 3")
    check(sorted(res["kinds"]) == ["galaxy", "star", "star"],
          f"pipeline kinds {[str(k) for k in res['kinds']]}")
    for key in ("completeness", "purity", "kind_accuracy"):
        check(rep[key] == 1.0, f"pipeline catalog {key} {rep[key]}")
    check(rep["pos_rms_arcsec"] < 0.2, f"pipeline position RMS {rep['pos_rms_arcsec']}")
    check(abs(rep["flux_rel_bias"]) < 0.2, f"pipeline flux bias {rep['flux_rel_bias']}")
    check(0.01 < pv < 0.99, f"pipeline PPC p-value {pv} outside (0.01, 0.99)")
    check(rhat <= PIPELINE_RHAT, f"pipeline max R-hat {rhat:.4f} > {PIPELINE_RHAT}")
    for name, n in counts.items():
        check(n > 0, f"the pipeline never launched {name}")
    shapes.check_totals(counts)
    pipeline_sweep_launches(run)
    return counts, shapes, run["scene"].stamps[0].counts.numel()


def shape_rows(card, shapes, tag, pix):
    """K1-fwd, K1-bwd and K7 at every shape a path launched them
    (``ShapeLaunches``) on pixel sets of ``pix`` real pixels each (an int,
    or {padded: real} where the sets differ), on the first inputs seen
    there: held against the plain version, the sets expanded to rows (K1-fwd rtol 2e-6, atol 1.0;
    K1-bwd rtol 5e-4, atol 5e-2; K7 rtol 1e-5, atol 1e-3), device ms per
    call (a CUDA graph of 20 calls, best of 3), the bound per call, the
    launches and the time lost, launches x (ms - bound).  Returns (K1 rows,
    K7 rows)."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import mog_field as mf

    fns = {"K1-fwd": (mf.loglik_fwd_cuda, mf._loglik_torch, FWD_TOL["galaxy"]),
           "K1-bwd": (mf.loglik_bwd_cuda, mf._loglik_bwd_torch, BWD_TOL),
           "K7": (mf.render_cuda, mf._render_torch, LAM_TOL)}
    k1, k7 = [], []
    for key in sorted(shapes.counts, key=lambda k: -shapes.counts[k]):
        kernel, b, c, n_sets, pix_pad = key
        real = pix[pix_pad] if isinstance(pix, dict) else pix
        n = shapes.counts[key]
        args, kw = shapes.inputs[key]
        fn, plain, tol = fns[kernel]
        n_pix_args = 3 if kernel == "K7" else 5
        rows = list(mf.rows_of_sets(tuple(args[6:6 + n_pix_args]), b))
        got, want = fn(*args, **kw), plain(*args[:6], *rows, *args[6 + n_pix_args:], **kw)
        if kernel == "K1-bwd":
            err = max(max_abs_err(g, w, *tol, f"{tag} {kernel} B={b} C={c}")
                      for g, w in zip(got, want))
        else:
            err = max_abs_err(got, want, *tol, f"{tag} {kernel} B={b} C={c}")
        ms = graph_ms(lambda: fn(*args, **kw))
        bound_ms, bound_by = (k7_bound(b, c, real, pix_pad, n_sets) if kernel == "K7"
                              else k1_bounds(b, c, real, pix_pad, n_sets)[kernel])
        sets = f" S={n_sets}" if n_sets > 1 else ""
        row = {"kernel": kernel, "shape": f"{tag} B={b} C={c}{sets}", "chains": b,
               "components": c, "sets": n_sets, "pixels": real, "pixels_padded": pix_pad,
               "launches": n, "max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "lost_s": n * (ms - bound_ms) * 1e-3}
        if kernel == "K7":
            k7.append(row)
        else:
            row["cb_t"] = list(mf.k1_geometry(b, pix_pad, n_sets))
            k1.append(row)
    print(f"[timing] K1 and K7 where the {tag} launches them (device ms per call: a CUDA graph "
          f"of 20 calls, best of 3), card: {card}", flush=True)
    for r in k1 + k7:
        print(f"    {r['kernel']} {r['shape']}: max abs err vs plain {r['max_abs_err']:.4g} "
              f"ms={r['ms']:.6f} bound={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"launches={r['launches']} lost={r['lost_s']:.6f} s", flush=True)
    return k1, k7


# ---------------------------------------------------------------------------
# the field catalog pipeline (phase g)
# ---------------------------------------------------------------------------

def pixel_set_checks(device):
    """K1-fwd, K1-bwd and K7 in their pixel-set mode at the field's shapes
    (PIXEL_SET_SHAPES: candidate cutouts of 24x24 = 576 pixels at R = 1
    and 2, group cutouts of 48x48 and 32x32 at R = 8 and 32; random planes
    around each set's cutout, ``random_pixel_set_problem``, padding
    included) against their plain versions on the sets expanded to rows:
    K1-fwd (centered and not) rtol 2e-6 + atol 0.5, K1-bwd rtol 5e-4 + atol
    5e-2, K7 LAM_TOL; each call twice, bitwise.  Returns the largest errors
    by kernel and the problems, to time them."""
    from celeste_tpu_torch.kernels import mog_field as mf

    errs = {"K1-fwd": 0.0, "K1-bwd": 0.0, "K7": 0.0}
    problems = {}
    for name, n_sets, r, c, side in PIXEL_SET_SHAPES:
        planes, sets = mf.random_pixel_set_problem(n_sets, r, c, side, seed=n_sets * r)
        planes = [torch.as_tensor(a, device=device) for a in planes]
        sets = [torch.as_tensor(a, device=device) for a in sets]
        b = n_sets * r
        rows = mf.rows_of_sets(tuple(sets), b)
        g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32),
                            device=device)
        what = f"pixel sets {name} B={b} C={c} S={n_sets} P={side * side}"
        for centered in (False, True):
            got = mf.loglik_fwd_cuda(*planes, *sets, centered=centered)
            check(torch.equal(got, mf.loglik_fwd_cuda(*planes, *sets, centered=centered)),
                  f"{what}: K1-fwd not bitwise repeatable")
            errs["K1-fwd"] = max(errs["K1-fwd"], max_abs_err(
                got, mf._loglik_torch(*planes, *rows, centered=centered), *FWD_TOL["star"],
                f"{what} K1-fwd"))
        got = mf.loglik_bwd_cuda(*planes, *sets, g)
        again = mf.loglik_bwd_cuda(*planes, *sets, g)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"{what}: K1-bwd not bitwise repeatable")
        want = mf._loglik_bwd_torch(*planes, *rows, g)
        errs["K1-bwd"] = max([errs["K1-bwd"]] + [max_abs_err(a, w, *BWD_TOL, f"{what} K1-bwd")
                                                 for a, w in zip(got, want)])
        lam = mf.render_cuda(*planes, sets[0], sets[1], sets[3])
        check(torch.equal(lam, mf.render_cuda(*planes, sets[0], sets[1], sets[3])),
              f"{what}: K7 not bitwise repeatable")
        errs["K7"] = max(errs["K7"], max_abs_err(
            lam, mf._render_torch(*planes, rows[0], rows[1], rows[3]), *LAM_TOL, f"{what} K7"))
        problems[name] = (planes, sets, g, side * side)
    print(f"[pixel sets] K1-fwd, K1-bwd, K7 at {[s_[0] for s_ in PIXEL_SET_SHAPES]} match their "
          f"plain versions (max abs err {errs}), bitwise repeatable", flush=True)
    return errs, problems


def pixel_set_timings(card, problems):
    """The pixel-set mode at PIXEL_SET_SHAPES: device ms per call of each
    kernel (a CUDA graph of 20 calls, best of 3), the plain version's (CUDA
    events, the sets expanded to rows) and the bound per call.  Returns
    {(kernel, shape): row}."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import mog_field as mf

    out = {}
    for name, (planes, sets, g, pix) in problems.items():
        b, c = planes[0].shape
        n_sets, pix_pad = sets[0].shape
        rows = mf.rows_of_sets(tuple(sets), b)
        calls = {"K1-fwd": (lambda: mf.loglik_fwd_cuda(*planes, *sets, centered=True),
                            lambda: mf._loglik_torch(*planes, *rows, centered=True)),
                 "K1-bwd": (lambda: mf.loglik_bwd_cuda(*planes, *sets, g),
                            lambda: mf._loglik_bwd_torch(*planes, *rows, g)),
                 "K7": (lambda: mf.render_cuda(*planes, sets[0], sets[1], sets[3]),
                        lambda: mf._render_torch(*planes, rows[0], rows[1], rows[3]))}
        bounds = k1_bounds(b, c, pix, pix_pad, n_sets)
        bounds["K7"] = k7_bound(b, c, pix, pix_pad, n_sets)
        for kernel, (fn, plain) in calls.items():
            ms, plain_ms = graph_ms(fn), time_ms(plain, 3)
            geometry = (mf.k7_geometry if kernel == "K7" else mf.k1_geometry)(b, pix_pad, n_sets)
            out[(kernel, name)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[kernel][0],
                                   "bound_by": bounds[kernel][1], "cb_t": list(geometry)}
    print(f"[timing] pixel-set mode (device ms per call: a CUDA graph of 20 calls, best of 3; "
          f"plain: CUDA events), card: {card}", flush=True)
    for (kernel, name), r in out.items():
        print(f"    {kernel} {name}: (CB, T)={tuple(r['cb_t'])} ms={r['ms']:.6f} "
              f"plain={r['plain_ms']:.6f} bound={r['bound_ms']:.6f} ({r['bound_by']})",
              flush=True)
    return out


def plain_rows(plain, planes, pixels, extra=(), chunk=32, **kw):
    """A plain version over chunks of rows (a [1024, 2400, 2304]
    intermediate is 22 GB whole), the pixel sets expanded to rows."""
    from celeste_tpu_torch.kernels import mog_field as mf

    b = planes[0].shape[0]
    rows = mf.rows_of_sets(tuple(pixels), b)
    outs = []
    for c0 in range(0, b, chunk):
        sl = slice(c0, c0 + chunk)
        pix = [t if t.shape[0] == 1 else t[sl] for t in rows]
        outs.append(plain(*(p[sl] for p in planes), *pix, *(e[sl] for e in extra), **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


@contextlib.contextmanager
def forced_path(staged):
    """The stamp kernels' wrappers take the staged (or the whole-row) path
    at any C inside the block."""
    from celeste_tpu_torch.kernels import mog_field as mf

    real = mf.components_staged
    mf.components_staged = lambda kernel, cb, c: staged
    try:
        yield
    finally:
        mf.components_staged = real


def large_c_checks(device, card):
    """Phase g, rows of LARGE_C components at LARGE_C_LAYOUTS (random planes
    around each set's cutout, the first C of 2400 components): K1-fwd
    (centered), K1-bwd and K7 against their plain versions (fwd rtol 2e-6 +
    atol 0.5, bwd rtol 5e-4 + atol 5e-2, K7 rtol 1e-5 + atol 1e-3), one
    launch a call, twice bitwise; where both paths fit, the staged and
    whole-row paths bitwise equal.  Then the field's group log density of
    a galaxy cluster linked into one group of 20 sources
    (``bench.field_scale.cluster_group``, 960 components a row) at 32
    chains: one K1-fwd and one K1-bwd launch, value and gradient against
    the CPU's plain mode on 4 of the chains.  Device ms per call at
    LARGE_C_TIMED (a CUDA graph of 5 calls, best of 3), the plain version's
    (its one call above, CUDA events), the bound.  Returns the rows."""
    from celeste_tpu_torch import field as tfield
    from celeste_tpu_torch.bench.field_scale import cluster_group
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    rows = []
    kernels = {"K1-fwd": ("fwd", mf.loglik_fwd_cuda, mf._loglik_torch, FWD_TOL["star"],
                          "mog_field_loglik_fwd"),
               "K1-bwd": ("bwd", mf.loglik_bwd_cuda, mf._loglik_bwd_torch, BWD_TOL,
                          "mog_field_loglik_bwd"),
               "K7": ("render", mf.render_cuda, mf._render_torch, LAM_TOL, "mog_field_render")}
    for name, n_sets, r, side in LARGE_C_LAYOUTS:
        planes_np, sets_np = mf.random_pixel_set_problem(n_sets, r, max(LARGE_C), side, seed=r)
        sets = [torch.as_tensor(a, device=device) for a in sets_np]
        b, pix_pad = n_sets * r, sets[0].shape[1]
        g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32),
                            device=device)
        for c in LARGE_C:
            planes = [torch.as_tensor(np.ascontiguousarray(a[:, :c]), device=device)
                      for a in planes_np]
            args = {"K1-fwd": ((*planes, *sets), {"centered": True}, ()),
                    "K1-bwd": ((*planes, *sets, g), {}, (g,)),
                    "K7": ((*planes, sets[0], sets[1], sets[3]), {}, ())}
            bounds = k1_bounds(b, c, side * side, pix_pad, n_sets)
            bounds["K7"] = k7_bound(b, c, side * side, pix_pad, n_sets)
            for kernel, (kind, fn, plain, tol, counter) in kernels.items():
                a, kw, extra = args[kernel]
                what = f"large C {name} {kernel} B={b} C={c}"
                before = mf.launch_counts()[counter]
                got = fn(*a, **kw)
                check(mf.launch_counts()[counter] == before + 1, f"{what}: not one launch")
                again = fn(*a, **kw)
                pix = a[6:6 + (3 if kernel == "K7" else 5)]
                want, plain_ms = once_ms(lambda: plain_rows(plain, planes, pix, extra, **kw))
                cb = (mf.k7_geometry if kernel == "K7" else mf.k1_geometry)(b, pix_pad, n_sets)[0]
                staged = mf.components_staged(kind, cb, c)
                both = mf.whole_row_smem(kind, cb, c) <= mf.SMEM_OPTIN
                other = None
                if both:
                    with forced_path(not staged):
                        other = fn(*a, **kw)
                if kernel == "K1-bwd":
                    check(all(torch.equal(x, y) for x, y in zip(got, again)),
                          f"{what}: not bitwise repeatable")
                    if both:
                        check(all(torch.equal(x, y) for x, y in zip(got, other)),
                              f"{what}: the staged and whole-row paths differ")
                    err = max(max_abs_err(x, w, *tol, what) for x, w in zip(got, want))
                else:
                    check(torch.equal(got, again), f"{what}: not bitwise repeatable")
                    check(other is None or torch.equal(got, other),
                          f"{what}: the staged and whole-row paths differ")
                    err = max_abs_err(got, want, *tol, what)
                row = {"kernel": kernel, "shape": f"{name} B={b} C={c}" + (
                           f" S={n_sets}" if n_sets > 1 else ""), "chains": b,
                       "components": c, "sets": n_sets, "pixels": side * side,
                       "pixels_padded": pix_pad, "cb": cb, "staged": staged,
                       "both_paths_bitwise": both, "max_abs_err": err, "launches": 0}
                if c in LARGE_C_TIMED:
                    row["ms"] = graph_ms(lambda: fn(*a, **kw), reps=5)
                    row["bound_ms"], row["bound_by"] = bounds[kernel]
                    row["plain_ms"] = plain_ms
                    row["lost_s"] = 0.0
                rows.append(row)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    out = {}
    for dev, n in (("cpu", 4), (device, 32)):
        scene, _, rects, is_star, pixels = cluster_group(dev)
        fr = tfield._Frames([scene.stamps[0]], [0], 1, priors)
        sets = [mf.pad_pixel_sets(*(torch.as_tensor(a[None], device=dev) for a in pixels))]
        logd = tfield._group_logdensity(fr, sets, torch.as_tensor(is_star[None], device=dev),
                                        torch.ones(1, len(is_star), dtype=torch.bool,
                                                   device=dev))
        x = (rects.reshape(1, -1)
             + 0.01 * np.random.default_rng(3).normal(size=(32, rects.size))).astype(np.float32)
        xt = torch.tensor(x[:n], device=dev, requires_grad=True)
        before = mf.launch_counts()
        val = logd(xt)
        (grad,) = torch.autograd.grad(val.sum(), xt)
        after = mf.launch_counts()
        out[str(dev)] = (val.detach().cpu()[:4], grad.cpu()[:4],
                         {k: after[k] - before[k] for k in after})
    check(out[str(device)][2] == {"mog_field_loglik_fwd": 1, "mog_field_loglik_bwd": 1,
                                  "mog_field_render": 0},
          f"the 20-source group's launches {out[str(device)][2]}")
    err_v = max_abs_err(out[str(device)][0], out["cpu"][0], *FWD_TOL["star"],
                        "the 20-source group's log density")
    err_g = max_abs_err(out[str(device)][1], out["cpu"][1], *BWD_TOL,
                        "the 20-source group's gradient")
    print(f"[large C] K1-fwd, K1-bwd, K7 at C={LARGE_C} on {[n for n, *_ in LARGE_C_LAYOUTS]} "
          f"match their plain versions, one launch a call, bitwise repeatable, staged == "
          f"whole-row where both fit; the 20-source group (960 components a row) at 32 chains: "
          f"value err {err_v:.4g}, gradient err {err_g:.4g} against the CPU ({card})", flush=True)
    for r in rows:
        if "ms" in r:
            print(f"    {r['kernel']} {r['shape']}: CB={r['cb']} staged={r['staged']} "
                  f"ms={r['ms']:.6f} plain={r['plain_ms']:.6f} bound={r['bound_ms']:.6f} "
                  f"({r['bound_by']}) "
                  f"max abs err {r['max_abs_err']:.4g}", flush=True)
    return rows


def field_stages():
    """Wrap the field pipeline's stage functions to record each call's K1
    and K7 launches and wall time: returns (the stage list, a function that
    restores them)."""
    from celeste_tpu_torch import field as tfield
    from celeste_tpu_torch.inference import type_switch as tts
    from celeste_tpu_torch.kernels import mog_field as mf

    stages = []

    def staged(name, fn):
        def call(*args, **kw):
            before, t0 = dict(mf.launch_counts()), time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            after = mf.launch_counts()
            rows = args[2].shape[0] if name == "classify" else None
            stages.append((name, {k: after[k] - before[k] for k in after},
                           time.perf_counter() - t0, rows))
            return out
        return call

    targets = ((tfield, "_det_fit_batch", "detect"), (tfield, "_classify_batch", "classify"),
               (tts, "sample_source_type_core", "type_switch"),
               (tfield, "_sample_groups", "sample"))
    orig = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for mod, attr, name in targets:
        setattr(mod, attr, staged(name, getattr(mod, attr)))

    def restore():
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)

    return stages, restore


def report_stages(tag, stages, map_steps):
    """Print each stage's launches and wall; fail unless every classify
    sweep launched K1 once each way per Adam step (plus one Hessian batch)
    whatever its candidate count."""
    for name, c, secs, rows in stages:
        k1 = (c["mog_field_loglik_fwd"], c["mog_field_loglik_bwd"])
        extra = ""
        if name == "classify":
            extra = (f" ({rows} candidates, {2 * rows} rows; per Adam step K1 "
                     f"{(k1[0] - 1) / map_steps:g} fwd, {(k1[1] - 1) / map_steps:g} bwd)")
            check(k1 == (map_steps + 1, map_steps + 1),
                  f"{tag}: a classify sweep of {rows} candidates launched K1 {k1} times, not "
                  f"{(map_steps + 1, map_steps + 1)}")
        print(f"[{tag}] {name}: K1 fwd {k1[0]} bwd {k1[1]}, K7 {c['mog_field_render']}, "
              f"{secs:.3f} s{extra}", flush=True)


def field_entry(device, name, overrides, map_steps):
    """One ``run_experiment`` of a field config with its stages and K1/K7
    launches by shape recorded; fails on a stamp kernel never launched and
    on launches by shape that do not sum to the counters."""
    stages, restore = field_stages()
    try:
        with ShapeLaunches() as shapes:
            cfg, res, seconds, counts = entry_run(name, overrides, device)
    finally:
        restore()
    report_stages(name, stages, map_steps)
    for kernel, n in counts.items():
        check(n > 0, f"{name} never launched {kernel}")
    shapes.check_totals(counts)
    return cfg, res, seconds, counts, shapes


def field_diagnostics(tag, art):
    """Print the groups' diagnostics and gate finite samples, max R-hat <
    FIELD_RHAT and divergence < FIELD_DIVERGENCE over every group."""
    diag = art["diagnostics"]
    rhat = max(d["rhat_max"] for d in diag)
    div = max(d["divergence_rate"] for d in diag)
    print(f"[{tag}] groups {art['n_groups']} (sizes {[len(m) for m in art['groups']]}, s_max "
          f"{art['s_max']}, cut {art['group_cut']}), samples {art['samples'].shape}; max R-hat "
          f"{rhat:.4f}, max divergence {div:.4f}, min ESS {min(d['ess_min'] for d in diag):.1f}, "
          f"accept {[round(d['accept_rate'], 3) for d in diag]}", flush=True)
    check(bool(np.isfinite(art["samples"]).all()), f"{tag}: non-finite samples")
    check(rhat < FIELD_RHAT, f"{tag}: max R-hat {rhat:.4f} >= {FIELD_RHAT}")
    check(div < FIELD_DIVERGENCE, f"{tag}: divergence {div:.4f} >= {FIELD_DIVERGENCE}")


def field_pixels(cut, gcut):
    """{padded pixels: real pixels} of a field run's candidate and group
    cutouts."""
    return {-(-side * side // 128) * 128: side * side for side in (cut, gcut)}


def field_path(device):
    """Phase g, ``field``: ``run_experiment`` as the config has it (96x96,
    5 sources, 32 chains, 100 + 300 steps, ``FieldConfig`` defaults, the
    type switch on), every counter set to 0 just before and read just
    after; the gates of tests/test_field.py's detection, classification and
    grouping tests (5 sources, kinds 4 stars and a galaxy, each entry within
    0.5 arcsec of a distinct truth, 4 groups with s_max 2, the pair a star
    and the galaxy) and the groups' max R-hat < 1.1 and divergence < 0.05.
    Returns (launches, ShapeLaunches, {padded pixels: real pixels})."""
    from celeste_tpu_torch.field import FieldConfig

    fc = FieldConfig()
    cfg, res, seconds, counts, shapes = field_entry(device, "field", {}, fc.map_steps)
    run = res["run"]
    catalog, art, scene, srcs = run["catalog"], run["artifacts"], run["scene"], run["sources"]
    truth = np.array([scene.wcs.equa2duas(s_["u"]) for s_ in srcs])
    est = np.array([e.du_mean for e in catalog])
    d = np.hypot(truth[:, None, 0] - est[None, :, 0], truth[:, None, 1] - est[None, :, 1])
    match = np.argmin(d, axis=1)
    groups = [e.extras["group"] for e in catalog]
    pair = [g for g in set(groups) if groups.count(g) == 2]
    print(f"[field] run_experiment field: {seconds:.3f} s, chains {cfg.n_chains}, warmup "
          f"{cfg.n_warmup}, steps {cfg.n_steps}; kinds {[e.kind for e in catalog]}, p_star "
          f"{[round(e.p_star, 4) for e in catalog]}, groups {groups}; offsets to the truth "
          f"{np.round(d[np.arange(len(truth)), match], 4).tolist()} arcsec; flux "
          f"{[np.round(e.flux_mean, 3).tolist() for e in catalog]} (truth "
          f"{[round(float(s_['flux'][2]), 3) for s_ in srcs]}); launches {counts}", flush=True)
    field_diagnostics("field", art)
    check(art["n_sources"] == 5, f"field: {art['n_sources']} sources, not 5")
    check(sorted(e.kind for e in catalog) == ["galaxy", "star", "star", "star", "star"],
          f"field kinds {[e.kind for e in catalog]}")
    check(len(set(match.tolist())) == 5, f"field: entries match {match.tolist()}, not 5 truths")
    check(float(d[np.arange(5), match].max()) < 0.5, "field: an entry 0.5 arcsec off its truth")
    check(art["n_groups"] == 4 and art["s_max"] == 2,
          f"field: {art['n_groups']} groups, s_max {art['s_max']}")
    check(len(pair) == 1 and sorted(e.kind for e in catalog if e.extras["group"] == pair[0])
          == ["galaxy", "star"], f"field: the blended pair's groups {groups}")
    return counts, shapes, field_pixels(fc.cut, art["group_cut"]), seconds


def field_survey_path(device):
    """Phase g, ``field_survey``: ``run_experiment`` as the config has it
    (256x1024, ~60 sources, 8 chains, 48 + 96 steps, sampled), counters as
    in ``field_path``; gates: completeness, purity and kind accuracy >= 0.9,
    matches >= 0.9 of the sources, position RMS < 0.1 arcsec, |flux bias| <
    0.05, position and flux z-RMS in [0.7, 1.4] and the groups' max R-hat <
    1.1 and divergence < 0.05.
    Returns (launches, ShapeLaunches, {padded pixels: real pixels}, wall)."""
    from celeste_tpu_torch.bench.field_scale import survey_scene_cfg

    fc = survey_scene_cfg()
    cfg, res, seconds, counts, shapes = field_entry(device, "field_survey", {}, fc.map_steps)
    run = res["run"]
    rep, art, srcs = run["accuracy"], run["artifacts"], run["sources"]
    print(f"[field_survey] run_experiment field_survey: {seconds:.3f} s, {len(srcs)} sources, "
          f"chains {cfg.n_chains}, warmup {cfg.n_warmup}, steps {cfg.n_steps}; catalog {art['n_sources']}, matched {rep['n_matched']}, completeness "
          f"{rep['completeness']}, purity {rep['purity']}, kind accuracy "
          f"{rep['kind_accuracy']}, pos rms {rep['pos_rms_arcsec']:.4f} arcsec, flux bias "
          f"{rep['flux_rel_bias']:.4f}, pos z rms {rep['pos_z_rms']}, flux z rms "
          f"{rep['flux_z_rms']}; {len(srcs) / seconds:.4f} sources/s; launches {counts}",
          flush=True)
    for key in ("completeness", "purity", "kind_accuracy"):
        check(rep[key] >= 0.9, f"field_survey {key} {rep[key]}")
    check(rep["n_matched"] >= 0.9 * len(srcs),
          f"field_survey: {rep['n_matched']} matched of {len(srcs)}")
    check(rep["pos_rms_arcsec"] < 0.1, f"field_survey position RMS {rep['pos_rms_arcsec']}")
    check(abs(rep["flux_rel_bias"]) < 0.05, f"field_survey flux bias {rep['flux_rel_bias']}")
    field_diagnostics("field_survey", art)
    for key in ("pos_z_rms", "flux_z_rms"):
        check(0.7 <= rep[key] <= 1.4, f"field_survey {key} {rep[key]} outside [0.7, 1.4]")
    return counts, shapes, field_pixels(fc.cut, art["group_cut"]), seconds


def field_resume_check(device, tmp):
    """Phase g, the field's checkpoint and resume: ``run_field_pipeline`` on
    the ``field`` config's frame at FIELD_RESUME (the cut of
    tests/test_field.py's resume test: 8 chains, 20 + 8 probe and 20 + 20
    steps, segments of 8, warmup windows of 9, 60-step MAP fits), once
    unbroken and once stopped by its logger after the first sampling
    segment and rerun on the checkpoint: samples and catalog bitwise equal.
    The stamp kernels' counters set to 0 before; K1 must launch."""
    from celeste_tpu_torch.experiments import CONFIGS, field_scene
    from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    class Stop(Exception):
        pass

    class StopAfterFirstSegment(MetricsLogger):
        def log(self, event, **kw):
            super().log(event, **kw)
            if event == "field_sample_segment":
                raise Stop

    mf.reset_launch_counts()
    t0 = time.perf_counter()
    scene, _ = field_scene(CONFIGS["field"], device)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    ck = os.path.join(tmp, "field_ck.npz")

    def run(path=None, logger=None):
        return run_field_pipeline(scene.stamps[0], band=0, n_bands=1,
                                  cfg=FieldConfig(checkpoint_path=path, **FIELD_RESUME),
                                  priors=priors, logger=logger)

    cat_u, art_u = run()
    stopped = False
    try:
        run(ck, StopAfterFirstSegment())
    except Stop:
        stopped = True
    check(stopped, "field resume: the stopped run did not stop")
    cat_r, art_r = run(ck)
    torch.cuda.synchronize()
    counts = mf.launch_counts()
    same = (np.array_equal(art_u["samples"], art_r["samples"])
            and all(np.array_equal(a.du_mean, b.du_mean)
                    and np.array_equal(a.flux_mean, b.flux_mean) for a, b in zip(cat_u, cat_r)))
    print(f"[field resume] unbroken, stopped after one segment, resumed: samples "
          f"{art_u['samples'].shape} bitwise equal: {same}; launches {counts}; wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    check(same, "field resume: the resumed run differs from the unbroken one")
    check(counts["mog_field_loglik_fwd"] > 0, "field resume never launched K1")


# ---------------------------------------------------------------------------
# checkpoints, warm-start caches, config 4 and the sharded ladder
# ---------------------------------------------------------------------------

def resume_check(tag, name, overrides, tmp, device, unbroken=None):
    """``run_experiment`` of ``name`` with ``overrides`` (n_steps in
    segments of checkpoint_every): the run stopped after segment 2 and
    resumed from its checkpoint against the unbroken run (``unbroken``, or
    run here), ``samples``, ``mean`` and ``rhat`` bitwise equal."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment

    def run(**kw):
        cfg = copy.deepcopy(CONFIGS[name])
        cfg.device = str(device)
        for k, v in {**overrides, **kw}.items():
            setattr(cfg, k, v)
        t0 = time.perf_counter()
        res = run_experiment(cfg)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    seg = overrides["checkpoint_every"]
    walls = {}
    if unbroken is None:
        unbroken, walls["unbroken"] = run(out=f"{tmp}/{tag}_full")
    _, walls["stopped"] = run(n_steps=2 * seg, out=f"{tmp}/{tag}_half")
    resumed, walls["resumed"] = run(resume=f"{tmp}/{tag}_half.ckpt.npz", out=f"{tmp}/{tag}_resumed")
    for key in ("samples", "mean", "rhat"):
        check(np.array_equal(resumed[key], unbroken[key]),
              f"{tag}: the resumed run's {key} differs from the unbroken run's")
    print(f"[resume] {tag} {name}, {overrides['n_steps']} steps in segments of {seg}: stopped "
          f"after 2 segments and resumed, samples/mean/rhat bitwise equal to the unbroken run "
          f"(max_rhat {float(np.max(unbroken['rhat'])):.4f}); walls "
          f"{ {k: round(v, 3) for k, v in walls.items()} }", flush=True)


def resume_path(device, tmp, crowded_unbroken):
    """Phase a: resumed runs bitwise equal to unbroken ones on the card,
    star_single with MH and HMC (K1's counters set to 0 before and read
    after) and crowded_field's ChEES (K2-K4's), whose unbroken run is phase
    8's entry run."""
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.kernels import tiled_field as tf

    t0 = time.perf_counter()
    mf.reset_launch_counts()
    resume_check("mh", "star_single", RESUME_MH, tmp, device)
    resume_check("hmc", "star_single", RESUME_HMC, tmp, device)
    k1 = mf.launch_counts()
    for kname in ("mog_field_loglik_fwd", "mog_field_loglik_bwd"):
        check(k1[kname] > 0, f"the resumed star_single runs never launched {kname}")
    tf.reset_launch_counts()
    resume_check("chees", "crowded_field", dict(ENTRY_CROWDED, tiled=True, n_galaxies=2), tmp,
                 device, unbroken=crowded_unbroken)
    tiled = tf.launch_counts()
    # every evaluation of a gradient sampler takes its gradient: K3 and K4
    for kname in ("tiled_field_fwd_lam", "tiled_field_bwd"):
        check(tiled[kname] > 0, f"the resumed crowded_field runs never launched {kname}")
    print(f"[resume] launches: K1 {k1}, tiled {tiled}; phase wall "
          f"{time.perf_counter() - t0:.3f}s", flush=True)


def cached_prep(logd, vec, tmp):
    """Phase b: config 5's preparation behind a fresh cache file: the first
    call misses and saves, the second hits (live-probe gap < 1 nat, the
    saved ensemble bitwise; the probe's no-gradient evaluation launches
    K2).  On the target shifted by +5 nats the cache's live probe, run on
    the saved states through the saved moments as a third call would run
    it, is off by >= 4 nats, past its 1-nat gate: the call would miss.  The
    fresh warmup such a miss runs is not paid here; the ChEES cache's
    shifted call below, and the CPU tests, run the whole miss.  Returns the
    first call's prep."""
    from celeste_tpu_torch.bench.config5 import (
        _live_probe_gap, config5_warmup_and_whiten_cached,
    )
    from celeste_tpu_torch.inference import whiten_logdensity
    from celeste_tpu_torch.kernels import tiled_field as tf

    path = str(Path(tmp) / "config5_prep.npz")
    t0 = time.perf_counter()
    prep = config5_warmup_and_whiten_cached(logd, vec, path, n_chains=C5_CHAINS, **C5_PREP)
    t_miss = time.perf_counter() - t0
    check(os.path.exists(path) and "probe_gap" not in prep, "the first cached prep did not miss")
    t0 = time.perf_counter()
    k2_before = tf.launch_counts()["tiled_field_fwd"]
    hit = config5_warmup_and_whiten_cached(logd, vec, path, n_chains=C5_CHAINS, **C5_PREP)
    t_hit = time.perf_counter() - t0
    check("probe_gap" in hit, "the second cached prep did not hit")
    check(tf.launch_counts()["tiled_field_fwd"] > k2_before, "the live probe never launched K2")
    check(hit["probe_gap"] < 1.0, f"cache hit's live-probe gap {hit['probe_gap']:.4g} >= 1 nat")
    for space in ("states_z", "states_x"):
        for f in ("x", "logp", "grad"):
            check(torch.equal(getattr(hit[space], f), getattr(prep[space], f)),
                  f"the cache hit's {space}.{f} is not the saved one")
    check(torch.equal(hit["inv_mass"], prep["inv_mass"]) and hit["step_z"] == prep["step_z"]
          and hit["step_size"] == prep["step_size"], "the cache hit's scalars differ")
    shifted_z, _, _ = whiten_logdensity(lambda x: logd(x) + 5.0, *hit["whiten_moments"])
    shift_gap = _live_probe_gap(shifted_z, hit["states_z"].x, hit["states_z"].logp)
    check(shift_gap >= 4.0, f"the +5-nat target's live-probe gap {shift_gap:.6g} < 4 nats")
    print(f"[cache] config-5 prep at {C5_CHAINS} chains: miss+save {t_miss:.3f}s, hit "
          f"{t_hit:.3f}s (live-probe gap {hit['probe_gap']:.6g} nats, ensemble bitwise), "
          f"+5 nats: live-probe gap {shift_gap:.6g} nats > 1, a miss", flush=True)
    return prep


def cached_chees_warm(prep, tmp):
    """Phase b, ChEES: the adaptation behind a fresh cache file, miss+save,
    then a hit (bitwise).  Returns the cache path, which the ChEES arm
    then reads."""
    from celeste_tpu_torch.bench.config5 import CHEES_WINDOW, MAX_LEAPFROG, _chees_warm_cached

    path = str(Path(tmp) / "config5_chees.npz")
    t0 = time.perf_counter()
    st1, eps1, traj1 = _chees_warm_cached(prep, path, C5_CHEES_WARMUP, CHEES_WINDOW,
                                          MAX_LEAPFROG)
    t_miss = time.perf_counter() - t0
    t0 = time.perf_counter()
    st2, eps2, traj2 = _chees_warm_cached(prep, path, C5_CHEES_WARMUP, CHEES_WINDOW,
                                          MAX_LEAPFROG)
    check(torch.equal(st2.xs, st1.xs) and torch.equal(st2.logps, st1.logps)
          and torch.equal(st2.grads, st1.grads) and eps2 == eps1 and traj2 == traj1,
          "the ChEES cache hit is not the saved warm state")
    print(f"[cache] config-5 ChEES warm: miss+save {t_miss:.3f}s, hit "
          f"{time.perf_counter() - t0:.3f}s (bitwise)", flush=True)
    return path, st1


def chees_cache_shift_miss(prep, path, saved):
    """Phase b, ChEES: the +5-nat target misses the cache (the live probe)."""
    from celeste_tpu_torch.bench.config5 import CHEES_WINDOW, MAX_LEAPFROG, _chees_warm_cached

    t0 = time.perf_counter()
    shifted = dict(prep, logd_z=lambda z: prep["logd_z"](z) + 5.0)
    st, _, _ = _chees_warm_cached(shifted, path, C5_CHEES_WARMUP, CHEES_WINDOW, MAX_LEAPFROG)
    gap = float((st.logps.double() - saved.logps.double()).abs().max())
    check(gap > 1.0, "the +5-nat target hit the ChEES cache")
    print(f"[cache] config-5 ChEES warm, +5 nats: miss ({time.perf_counter() - t0:.3f}s; the "
          f"fresh ensemble's logps {gap:.4g} nats from the saved)", flush=True)


def quasar_entry(device):
    """Phase c: config 4 through run_experiment at the JAX package's
    configuration (8 systems x 8 temperatures, slice inner), cut in steps by
    QUASAR_ENTRY.  Gates: finite z, swap rate > 0.05, a fraction > 0.3 of z
    within 0.25 of z_true."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest", "TF32 is on for float32 matmuls")
    cfg = copy.deepcopy(CONFIGS["quasar_photoz"])
    cfg.device = str(device)
    for k, v in QUASAR_ENTRY.items():
        setattr(cfg, k, v)
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    z = res["z"]
    near = float(np.mean(np.abs(z - res["z_true"]) < 0.25))
    print(f"[config 4] run_experiment quasar_photoz: {cfg.n_chains} systems x {cfg.n_temps} temps, "
          f"slice inner, {cfg.n_steps} steps ({cfg.n_warmup} burned): wall={wall:.3f}s z_true="
          f"{res['z_true']:.4f} z median={float(np.median(z)):.4f} near_fraction={near:.4f} "
          f"swap_rate={res['swap_rate']:.4f} calls_per_sweep={res['calls_per_sweep']:.3f}",
          flush=True)
    check(z.shape == (cfg.n_chains, cfg.n_steps - cfg.n_warmup) and bool(np.isfinite(z).all()),
          f"config 4: z shape {z.shape} or non-finite")
    check(res["swap_rate"] > 0.05, f"config 4: swap rate {res['swap_rate']:.4f} <= 0.05")
    check(near > 0.3, f"config 4: only {near:.4f} of z within 0.25 of z_true")


def photoz_bench_batch(device, card):
    """Phase d: the bench's config-4 batch (bench.py _bench_photoz_batch):
    256 targets from default_rng(17), the default basis, 64-point filters, 6
    temperatures, hmc_adaptive, 150 warmup + 400 steps in segments of 100,
    the 8192-point grid.  Gate: z-recovery (|median - z_true| < 0.25) >= 0.88."""
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, project_to_bands, run_photo_z_batch_segmented,
        sdss_like_filterbank,
    )

    basis, filt = QuasarBasis.default(device), sdss_like_filterbank(n_pts=64, device=device)
    n = PHOTOZ_TARGETS
    rng = np.random.default_rng(17)
    z_true = rng.uniform(0.5, 4.0, n)
    ws = rng.dirichlet(np.ones(basis.n_basis), size=n)
    f_clean = project_to_bands(basis, filt, torch.as_tensor(ws, dtype=torch.float32,
                                                            device=device),
                               2.0, torch.as_tensor(z_true, dtype=torch.float32,
                                                    device=device)).cpu().numpy()
    flux, err = [], []
    for i in range(n):
        e = 0.03 * np.abs(f_clean[i]) + 1e-5
        flux.append(f_clean[i] + rng.normal(size=e.shape) * e)
        err.append(e)
    flux, err = np.stack(flux).astype(np.float32), np.stack(err).astype(np.float32)
    cfg = PhotoZConfig(n_temps=6, n_steps=400, n_warmup=150, n_systems=1, inner="hmc_adaptive")
    t0 = time.perf_counter()
    out = run_photo_z_batch_segmented(5, basis, filt, flux, err, cfg, segment_steps=100,
                                      device=device)
    wall = time.perf_counter() - t0
    z_med = np.median(out["z"].cpu().numpy().reshape(n, -1), axis=1)
    recov = float(np.mean(np.abs(z_med - z_true) < 0.25))
    seg_s = out["timings"]["segment_s"]
    steady = n / (float(np.mean(seg_s[1:])) * len(seg_s))
    print(f"[config 4 batch] {n} targets x 6 temps, hmc_adaptive, 150 warmup + 400 steps in "
          f"segments of 100: wall {wall:.3f}s (warmup {out['timings']['init_s']:.3f}s, segments "
          f"{[round(t, 3) for t in seg_s]}), {n / wall:.4f} targets/s full wall, {steady:.4f} "
          f"steady; z-recovery {recov:.4f}, swap rate {float(out['swap_rate']):.4f} ({card})",
          flush=True)
    check(out["n_steps_done"] == cfg.n_steps, "the photo-z batch stopped early")
    check(bool(torch.isfinite(out["z"]).all()), "the photo-z batch: non-finite z")
    check(recov >= 0.88, f"the photo-z batch's z-recovery {recov:.4f} < 0.88")


def ladder_run(mesh, device):
    """The bimodal 2-D ladder of the JAX package's parity test (8 temperatures
    from 1 to 0.05, MH with scales 0.4, 3 systems), 20 steps: in device
    (``mesh=None``) or sharded over ``mesh['temps']``.  Returns (xs, logps
    of this rank's replicas, every step's swap decisions), on the host."""
    from celeste_tpu_torch.inference.tempering import (
        geometric_ladder, mh_at_beta, pt_init, pt_kernel,
    )
    from celeste_tpu_torch.multichip import _bimodal
    from celeste_tpu_torch.parallel.pt_sharded import (
        LadderShard, sharded_pt_init, sharded_pt_kernel,
    )

    betas = geometric_ladder(LADDER_TEMPS, 0.05, device)
    scales = torch.full((2,), 0.4, device=device)
    xs0 = torch.as_tensor(np.random.default_rng(0).normal(size=(3, LADDER_TEMPS, 2)),
                          dtype=torch.float32, device=device)
    if mesh is None:
        kern = pt_kernel(_bimodal, mh_at_beta(_bimodal, scales), betas)
        state = pt_init(xs0, _bimodal)
    else:
        inner = mh_at_beta(_bimodal, scales, noise=LadderShard(mesh, "temps", LADDER_TEMPS))
        kern = sharded_pt_kernel(_bimodal, inner, betas, mesh, "temps")
        state = sharded_pt_init(xs0, _bimodal, mesh, "temps")
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    accepts = []
    with torch.no_grad():
        for _ in range(LADDER_STEPS):
            state, info = kern(gen, state)
            accepts.append(info.swap_accept.cpu())
    return state.xs.cpu(), state.logps.cpu(), torch.stack(accepts)


def photoz_sharded_run(mesh, device):
    """The JAX package's sharded photo-z parity run
    (tests/test_collectives.py:296): the default basis, 64-point filters, a
    target at z = 2 with 2% errors, 4 temperatures, hmc_adaptive, 25 steps
    after a 15-step warmup, the exact projection; in device or sharded.
    Returns the cold chain's kept vectors on the host."""
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, project_to_bands, run_photo_z, run_photo_z_sharded,
        sdss_like_filterbank,
    )

    basis, filt = QuasarBasis.default(device), sdss_like_filterbank(n_pts=64, device=device)
    flux = project_to_bands(basis, filt, torch.full((4,), 0.25, device=device), 1.0,
                            2.0).cpu().numpy()
    err = 0.02 * np.abs(flux) + 1e-4
    cfg = PhotoZConfig(n_temps=4, n_steps=25, n_warmup=5, n_systems=1, inner="hmc_adaptive",
                       pt_warmup_steps=15, flux_grid_n=0)
    out = (run_photo_z(5, basis, filt, flux, err, cfg, device=device) if mesh is None
           else run_photo_z_sharded(5, basis, filt, flux, err, mesh, cfg, device=device))
    return out["vec"].cpu()


def sharded_ladder_world2_rank():
    """One of two gloo ranks on the one card: the sharded ladder and the
    sharded photo-z run over a two-rank ``temps`` mesh."""
    from celeste_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"temps": 2}, "cuda")
    return ladder_run(mesh, device), photoz_sharded_run(mesh, device)


def check_ladder(tag, got, want):
    """The sharded ladder (its ranks' replicas concatenated) against the
    in-device one: xs rtol 1e-5, atol 1e-5; logps rtol 1e-4, atol 1e-4;
    every step's swap decisions equal."""
    xs, lp, acc = got
    ex = max_abs_err(xs, want[0], 1e-5, 1e-5, f"{tag}: ladder xs")
    el = max_abs_err(lp, want[1], 1e-4, 1e-4, f"{tag}: ladder logps")
    check(torch.equal(acc, want[2]), f"{tag}: a swap decision differs")
    return ex, el


def sharded_ladder_path(device):
    """Phase e: the sharded ladder on a one-rank mesh in this process and on
    two gloo ranks on the one card, against the in-device ladder; the
    sharded photo-z run (hmc_adaptive) against run_photo_z (vec rtol 2e-4,
    atol 2e-5) at both."""
    from celeste_tpu_torch.parallel import launch, make_mesh

    t0 = time.perf_counter()
    want = ladder_run(None, device)
    check(bool(want[2].any()), "the in-device ladder accepted no swap")
    want_vec = photoz_sharded_run(None, device)
    mesh = make_mesh({"temps": 1}, "cuda")
    e1 = check_ladder("one rank", ladder_run(mesh, device), want)
    v1 = max_abs_err(photoz_sharded_run(mesh, device), want_vec, 2e-4, 2e-5,
                     "one-rank sharded photo-z vs run_photo_z")
    ranks = launch(sharded_ladder_world2_rank, 2, backend="gloo")
    got = tuple(torch.cat([r[0][i] for r in ranks], dim=-2 if i == 0 else -1) for i in range(2))
    e2 = check_ladder("two ranks", got + (ranks[0][0][2],), want)
    check(torch.equal(ranks[1][0][2], ranks[0][0][2]), "the two ranks' swap decisions differ")
    v2 = max(max_abs_err(r[1], want_vec, 2e-4, 2e-5, f"two-rank sharded photo-z rank {i}")
             for i, r in enumerate(ranks))
    print(f"[sharded ladder] bimodal 2-D, {LADDER_TEMPS} temps, 3 systems, {LADDER_STEPS} steps, "
          f"{int(want[2].sum())} swaps: one rank (nccl) xs/logps max abs err {e1[0]:.4g}/"
          f"{e1[1]:.4g}, two gloo ranks {e2[0]:.4g}/{e2[1]:.4g}, swap decisions equal; sharded "
          f"photo-z vs run_photo_z {v1:.4g} (one rank), {v2:.4g} (two); "
          f"{time.perf_counter() - t0:.3f}s", flush=True)


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


def k7_bound(b, c, pix, pix_pad, n_sets=1):
    """K7's bound per call for b chains of c components over pix real
    pixels (pix_pad rendered) of each of n_sets pixel sets: a term's form
    and sum and its exponential per (chain, pixel, component); the planes
    and the pixel arrays read once, the [B, P] images written once."""
    f4 = 4
    return bound(b * pix * c * (FLOPS_TERM_FORM + FLOPS_TERM_SUM),
                 6 * b * c * f4 + 3 * n_sets * pix_pad * f4 + b * pix_pad * f4, b * pix * c)


def bound(flops, nbytes, special):
    """(least time in ms, what bounds it) for ``flops`` float32 operations,
    ``special`` exponentials and logarithms and ``nbytes`` moved, at the
    card's peaks."""
    times = {"operations": flops / FP32_FLOPS_PER_S, "special functions": special / SPECIAL_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def k1_bounds(b, c, pix, pix_pad, n_sets=1):
    """K1-fwd's and K1-bwd's bounds per call for b chains of c components
    on pix real pixels (pix_pad staged) of each of n_sets pixel sets: the
    terms and pixels this data needs, the planes and pixel arrays read once,
    the outputs written once."""
    f4 = 4
    planes, pixel_arrays, terms = 6 * b * c * f4, 5 * n_sets * pix_pad * f4, b * pix * c
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


def tiled_bounds(buckets, sentinel, n_comp, b):
    """K2-K6's bounds per bucket call of a table's ``buckets`` at ``b``
    chains, the planes' last slot ``sentinel``: terms count the table
    entries that are not the sentinel (the work this data needs); the
    planes, the table, the pixel arrays and the column lists read once,
    lambda and the outputs written once; over all buckets, divided by their
    launches."""
    f4 = 4
    width = (sentinel + 1) * n_comp
    planes = 6 * b * width * f4
    entries = sum(int((bk.tile_src != sentinel).sum()) for bk in buckets) * n_comp * b
    tiles = sum(bk.tile_src.shape[0] for bk in buckets)
    slots = sum(bk.tile_src.numel() for bk in buckets)
    terms, table = entries * 1024, slots * f4
    cols = (len(buckets) * (width + 1) + slots * n_comp) * f4
    lam, pixels = tiles * b * 1024 * f4, tiles * b * 1024

    def per_call(ms_by):
        return ms_by[0] / len(buckets), ms_by[1]

    fwd = terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM) + pixels * FLOPS_PIXEL_LOGLIK
    bwd = terms * (FLOPS_TERM_FORM + FLOPS_TERM_MOMENTS) + entries * FLOPS_ENTRY_EPILOGUE
    return {
        "K2": per_call(bound(fwd, planes + table + 5 * tiles * 1024 * f4 + tiles * b * f4,
                             terms + pixels)),
        "K3": per_call(bound(fwd, planes + table + 5 * tiles * 1024 * f4 + tiles * b * f4 + lam,
                             terms + pixels)),
        "K4": per_call(bound(bwd + pixels * FLOPS_PIXEL_GLAM,
                             2 * planes + table + 4 * tiles * 1024 * f4 + lam + b * f4 + cols,
                             terms)),
        "K5": per_call(bound(terms * (FLOPS_TERM_FORM + FLOPS_TERM_SUM),
                             planes + table + 2 * tiles * 1024 * f4 + lam, terms)),
        "K6": per_call(bound(bwd, 2 * planes + table + 2 * tiles * 1024 * f4 + lam + cols,
                             terms)),
    }


def scene_prior_bounds(prep, b):
    """The prior kernels' bounds in ms at ``b`` chains, bytes over the HBM
    rate (their FP32 work, a few special functions a source band, is far
    below it): the forward reads the states and writes a float a chain; the
    backward reads the states and the cotangent and writes the gradient."""
    states = b * prep.d_total * 4
    return (states + b * 4) / HBM_BYTES_PER_S * 1e3, (2 * states + b * 4) / HBM_BYTES_PER_S * 1e3


def scene_prior_checks(device, card, config5):
    """The prior kernels against ``_crowded_logprior`` at SCENE_PLANES_SHAPES
    (config 5's truth plus noise of 0.01): the values rtol 2e-6, atol 1e-4;
    per state column, the gradient's distance from the plain one in float64
    at most 4 times the float32 plain version's plus 1e-4 of the column's
    largest magnitude; two calls of each kernel bitwise; then each timed
    (best of 3 runs of 20 calls) beside its bound and the plain version (the
    plain backward's time is that of the plain forward and its autograd
    backward, less the forward's).  Prints and returns the rows."""
    from celeste_tpu_torch.bench.config5 import build_config5_multiband
    from celeste_tpu_torch.kernels import scene_prior as sp
    from celeste_tpu_torch.model.priors import SourcePriors

    builds = {1: config5, 3: build_config5_multiband(device=device)}
    rows = []
    for name, b, nb in SCENE_PLANES_SHAPES:
        _, _, vec, info = builds[nb]
        prep = sp.ScenePrior(info["scene"], SourcePriors(), device)
        gen = torch.Generator(device=device).manual_seed(19)
        vecs = vec[None] + 0.01 * torch.randn(b, vec.shape[0], generator=gen, device=device)
        got, want = sp.scene_prior_fwd_cuda(prep, vecs), prep.plain(vecs)
        err_fwd = max_abs_err(got, want, 2e-6, 1e-4, f"{name}: the prior forward")
        g = torch.randn(b, generator=gen, device=device)
        grad = sp.scene_prior_bwd_cuda(prep, vecs, g)
        x = vecs.clone().requires_grad_(True)

        def plain_vjp(x=x, g=g):
            return torch.autograd.grad(prep.plain(x), x, g)[0]

        want_g = plain_vjp()
        ref = plain_vjp(vecs.double().requires_grad_(True), g.double())
        err_g = (grad.double() - ref).abs().amax(dim=0)
        bound = (4.0 * (want_g.double() - ref).abs().amax(dim=0)
                 + 1e-4 * ref.abs().amax(dim=0))
        check(bool((err_g <= bound).all()),
              f"{name}: the prior backward is off the plain gradient by {float(err_g.max()):.4g}")
        err_g = float((grad - want_g).abs().max())
        check(torch.equal(got, sp.scene_prior_fwd_cuda(prep, vecs)),
              f"{name}: two prior forward calls differ")
        check(torch.equal(grad, sp.scene_prior_bwd_cuda(prep, vecs, g)),
              f"{name}: two prior backward calls differ")
        fwd_bound, bwd_bound = scene_prior_bounds(prep, b)
        fwd_ms = time_ms(lambda: sp.scene_prior_fwd_cuda(prep, vecs), 20)
        bwd_ms = time_ms(lambda: sp.scene_prior_bwd_cuda(prep, vecs, g), 20)
        plain_fwd_ms = time_ms(lambda: prep.plain(vecs), 3)
        plain_vjp_ms = time_ms(plain_vjp, 3)
        for kernel, ms, bound_ms, plain_ms, err in (
                ("prior", fwd_ms, fwd_bound, plain_fwd_ms, err_fwd),
                ("prior-bwd", bwd_ms, bwd_bound, plain_vjp_ms - plain_fwd_ms, err_g)):
            check(bound_ms <= ms, f"{name} {kernel}: {ms:.6f} ms under its bound {bound_ms:.6f}")
            rows.append({"kernel": kernel, "shape": name, "chains": b, "bands": nb,
                         "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                         "plain_ms": plain_ms, "max_abs_err": err, "card": card})
            print(f"[kernels] {kernel} {name} B={b}: {ms:.6f} ms, bound {bound_ms:.6f} ms "
                  f"(bytes), plain {plain_ms:.6f} ms, max abs err {err:.4g}", flush=True)
        del got, want, grad, x, want_g, ref
        torch.cuda.empty_cache()
    print(json.dumps({"scene_prior": rows}), flush=True)
    return rows


def kernel_bounds(config5, sharded5):
    """Each kernel's bound per wrapper call at the shapes it is timed at:
    config 1's 25x25 stamp at B=65536 (625 pixels, padded to 640), config
    5's buckets at B=1024 (the single-device tables for K2-K4, whose bound
    over both buckets is divided by their two launches; the one-rank sharded
    table for K5 and K6; ``tiled_bounds``)."""
    from celeste_tpu_torch.model.galaxy import N_GAL

    f4 = 4
    out = k1_bounds(BENCH_CHAINS, 3, 625, 640)
    b = TIMING_CHAINS[0]
    sentinel = config5[3]["scene"].n_sources * N_GAL
    single = tiled_bounds(config5[3]["tiled_data"].bucket_tables, sentinel, 3, b)
    sharded = tiled_bounds(sharded5["loglik"].buckets, sentinel, 3, b)
    out.update({k: single[k] for k in ("K2", "K3", "K4")})
    out.update({k: sharded[k] for k in ("K5", "K6")})
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
    from celeste_tpu_torch.kernels import scene_planes as sp
    from celeste_tpu_torch.kernels import scene_prior as spr
    from celeste_tpu_torch.kernels import tiled_field as tf
    from celeste_tpu_torch.parallel import process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    # checkpoints and warm-start caches of phases a and b; removed at the end
    tmp_dir = tempfile.TemporaryDirectory(prefix="celeste_smoke_")
    tmp = tmp_dir.name

    # one nvcc per library, started together
    with ThreadPoolExecutor(max_workers=5) as pool:
        libs = list(pool.map(lambda m: m.build_kernels(), (mf, tf, ms, sp, spr)))
    print(f"[build] {', '.join(lib.name for lib in libs)} built and loaded in "
          f"{time.perf_counter() - t_start:.3f} s", flush=True)
    laps = [t_start]

    def lap(phase):
        laps.append(time.perf_counter())
        print(f"[wall] {phase}: {laps[-1] - laps[-2]:.3f} s (script {laps[-1] - t_start:.3f} s)",
              flush=True)

    lap("build")

    k1_errs = stamp_kernel_checks(device)
    config5 = build_config5(device=device)
    planes_rows = scene_planes_checks(device, card, config5)
    prior_rows = scene_prior_checks(device, card, config5)
    tiled_errs = tiled_kernel_checks(device, config5)
    render_errs = render_kernel_checks(device, build_config5_sharded(config5[3], None))
    lap("kernel checks, K1-K6 and the plane kernels on config 5")
    large_tile = large_tile_checks(device, card)
    lap("phase 4c, K2-K6 past the whole-tile staging")
    k7_err = stamp_render_checks(device, config5)
    k8_errs = sep_kernel_checks(device)
    set_errs, set_problems = pixel_set_checks(device)
    oracle_checks(device, config5)
    dense_gradient_check(device, config5)
    oracle_checks_23(device)
    lap("kernel and oracle checks")

    mf.reset_launch_counts()
    runs = config1_path(device)
    k1_counts = mf.launch_counts()
    for sampler, cfg, res, seconds, after in runs:
        report_config1(sampler, cfg, res, seconds, after)
    check(runs[0][4]["mog_field_loglik_fwd"] > 0, "MH run never launched the forward kernel")
    for name in ("mog_field_loglik_fwd", "mog_field_loglik_bwd"):
        check(k1_counts[name] > 0, f"the config-1 path never launched {name}")
    lap("config 1")

    planes_before, prior_before = sp.launch_counts(), spr.launch_counts()
    mf.reset_launch_counts()
    tf.reset_launch_counts()
    dense_counts, crowded_unbroken = config5_path(device, tmp)
    c5_counts = tf.launch_counts()
    print(f"[config 5] launches: {c5_counts} (stamp kernels: {mf.launch_counts()})", flush=True)
    for name in ("tiled_field_fwd", "tiled_field_fwd_lam", "tiled_field_bwd"):
        check(c5_counts[name] > 0, f"the config-5 path never launched {name}")
    lap("config 5 and the crowded_field entry run")
    cl_counts = crowded_large_path(device)
    lap("phase 8c, crowded_field past the whole-tile staging")

    mf.reset_launch_counts()
    tf.reset_launch_counts()
    multiband, mb_per_grad = multiband_path(device)
    mb_counts = tf.launch_counts()
    print(f"[config 5 gri] launches: {mb_counts} (stamp kernels: {mf.launch_counts()})",
          flush=True)
    for name in ("tiled_field_fwd", "tiled_field_fwd_lam", "tiled_field_bwd"):
        check(mb_counts[name] > 0, f"the three-band config-5 path never launched {name}")
    # the plane kernels' launches on the three config-5 paths (one band, phase
    # 8c, three bands)
    planes_launches = [n - planes_before[k] for k, n in sp.launch_counts().items()]
    check(min(planes_launches) > 0, f"the config-5 paths launched the plane kernels "
                                    f"{planes_launches} times")
    prior_launches = [n - prior_before[k] for k, n in spr.launch_counts().items()]
    check(min(prior_launches) > 0, f"the config-5 paths launched the prior kernels "
                                   f"{prior_launches} times")
    lap("config 5 in three bands")

    resume_path(device, tmp, crowded_unbroken)
    lap("phase a, resume")
    quasar_entry(device)
    photoz_bench_batch(device, card)
    lap("config 4")

    runs23 = configs23_path(device)
    k7_launches, k7_shapes = ppc_path(device, runs23)
    k8_counts, k1_65536 = sep_entry_path(device)
    lap("configs 2 and 3, the PPC, K8's entry")
    pipe_counts, pipe_shapes, pipe_pix = pipeline_path(device)
    lap("phase f, the stamp pipeline")
    t_g = time.perf_counter()
    field_counts, field_shapes, field_pix, field_s = field_path(device)
    survey_counts, survey_shapes, survey_pix, survey_s = field_survey_path(device)
    field_resume_check(device, tmp)
    print(f"[phase g] field {field_s:.3f} s, field_survey {survey_s:.3f} s; phase wall "
          f"{time.perf_counter() - t_g:.3f} s", flush=True)
    lap("phase g, the field")
    large_c = large_c_checks(device, card)
    lap("phase g, rows of 400-2400 components")
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
        sharded_ladder_path(device)
        lap("sharded config 5, the two-rank checks, the sharded ladder")

        t1 = config1_timings(device, card)
        t5 = config5_timings(device, card, config5)
        multiband_timings(device, card, multiband)
        tr = render_timings(card, sharded5, t5["vg_ms"])
        t8 = sep_timings(device, card)
        t7 = stamp_render_timings(device, card, config5)
        k7_rows = k7_shape_timings(card, k7_shapes)
        k1_rows = k1_shape_timings(device, card, config5, k1_launches)
        pipe_k1_rows, pipe_k7_rows = shape_rows(card, pipe_shapes, "pipeline", pipe_pix)
        k1_rows += pipe_k1_rows
        k7_rows += pipe_k7_rows
        for tag, shapes_, pix_ in (("field", field_shapes, field_pix),
                                   ("field_survey", survey_shapes, survey_pix)):
            rows_k1, rows_k7 = shape_rows(card, shapes_, tag, pix_)
            k1_rows += rows_k1
            k7_rows += rows_k7
        t_sets = pixel_set_timings(card, set_problems)
        bounds = kernel_bounds(config5, sharded5)
        lap("timings")
    tiled = "celeste_tpu/kernels/tiled_field.py"
    # K2-K4's launches: both config-5 paths' and the 32-source crowded_field's
    tiled_counts = (c5_counts, mb_counts, cl_counts)
    # the large-tile rows of the 32-source field: that run's launches, the
    # same on each of its buckets; lost = launches x (ms - bound)
    n, ng, (h, w) = (ENTRY_CROWDED_LARGE[k] for k in ("n_sources", "n_galaxies", "shape"))
    for r in large_tile:
        if r["shape"].startswith(f"crowded_field {n}/{ng} {h}x{w} bucket"):
            r["launches"] = cl_counts[TILED_COUNTERS[r["kernel"]]] // r["buckets"]
            r["lost_s"] = r["launches"] * (r["ms"] - r["bound_ms"]) * 1e-3
    t5b, trb = t5[TIMING_CHAINS[0]], tr[TIMING_CHAINS[0]]
    # K1's launches: config 1's path and the pipeline's; K7's: the PPC's and
    # the pipeline's
    rows = [
        ("mog_field_loglik_fwd", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:80", "K1-fwd",
         k1_counts["mog_field_loglik_fwd"] + pipe_counts["mog_field_loglik_fwd"], k1_errs["fwd"],
         t1["fwd_ms"], t1["fwd_plain_ms"]),
        ("mog_field_loglik_bwd", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:182",
         "K1-bwd", k1_counts["mog_field_loglik_bwd"] + pipe_counts["mog_field_loglik_bwd"],
         k1_errs["bwd"], t1["bwd_ms"], t1["bwd_plain_ms"]),
        ("tiled_field_fwd", "tiled_field.cu", f"{tiled}:57", "K2",
         sum(c["tiled_field_fwd"] for c in tiled_counts), tiled_errs["K2"],
         t5b["K2"], t5b["K2_plain"]),
        ("tiled_field_fwd_lam", "tiled_field.cu", f"{tiled}:84", "K3",
         sum(c["tiled_field_fwd_lam"] for c in tiled_counts), tiled_errs["K3"],
         t5b["K3"], t5b["K3_plain"]),
        ("tiled_field_bwd", "tiled_field.cu", f"{tiled}:108", "K4",
         sum(c["tiled_field_bwd"] for c in tiled_counts), tiled_errs["K4"],
         t5b["K4"], t5b["K4_plain"]),
        ("tiled_field_render", "tiled_field.cu", f"{tiled}:632", "K5",
         sh_counts["tiled_field_render"], render_errs["K5"], trb["K5"], trb["K5_plain"]),
        ("tiled_field_render_bwd", "tiled_field.cu", f"{tiled}:652", "K6",
         sh_counts["tiled_field_render_bwd"], render_errs["K6"], trb["K6"], trb["K6_plain"]),
        ("mog_field_render", "mog_field.cu", "celeste_tpu/kernels/mog_field.py:103", "K7",
         k7_launches + pipe_counts["mog_field_render"], k7_err, t7["K7_field_ms"],
         t7["K7_field_plain_ms"]),
        ("mog_field_sep_fwd", "mog_field_sep.cu", "celeste_tpu/kernels/mog_field_sep.py:71",
         "K8-fwd", k8_counts["mog_field_sep_fwd"], k8_errs["fwd"], t8["K8_fwd_ms"],
         t8["K8_fwd_plain_ms"]),
        ("mog_field_sep_bwd", "mog_field_sep.cu", "celeste_tpu/kernels/mog_field_sep.py:163",
         "K8-bwd", k8_counts["mog_field_sep_bwd"], k8_errs["bwd"], t8["K8_bwd_ms"],
         t8["K8_bwd_plain_ms"]),
    ]
    # the plane kernels: the config-5 paths' launches, timed at the c5_r
    # cell's shape (SCENE_PLANES_SHAPES' first)
    for key, launches in zip(("planes-fwd", "planes-bwd"), planes_launches):
        r = next(r for r in planes_rows if r["kernel"] == key)
        bounds[key] = (r["bound_ms"], r["bound_by"])
        rows.append((f"scene_planes_{key[-3:]}", "scene_planes.cu",
                     "none: the plain per-source graph, which XLA fuses "
                     "(celeste_tpu/kernels/tiled_field.py scene_planes_blocked)", key, launches,
                     r["max_abs_err"], r["ms"], r["plain_ms"]))
    # the prior kernels likewise
    for key, launches in zip(("prior", "prior-bwd"), prior_launches):
        r = next(r for r in prior_rows if r["kernel"] == key)
        bounds[key] = (r["bound_ms"], r["bound_by"])
        rows.append(("scene_prior_" + ("bwd" if key.endswith("bwd") else "fwd"), "scene_prior.cu",
                     "none: the plain per-source graph, which XLA fuses "
                     "(celeste_tpu/parallel/crowded.py _crowded_logprior)", key, launches,
                     r["max_abs_err"], r["ms"], r["plain_ms"]))
    # the pixel-set mode: launches of both field paths, timed at the field's
    # group sampling shape (K1) and its candidate cutouts (K7)
    for key, shape in (("K1-fwd", "group 48x48 R=32"), ("K1-bwd", "group 48x48 R=32"),
                       ("K7", "cutout R=1")):
        name, src, replaces = next((r[0], r[1], r[2]) for r in rows if r[3] == key)
        t = t_sets[(key, shape)]
        bounds[f"{key} sets"] = (t["bound_ms"], t["bound_by"])
        rows.append((f"{name} [S, P] pixel sets, {shape}", src, replaces, f"{key} sets",
                     field_counts[name] + survey_counts[name], set_errs[key], t["ms"],
                     t["plain_ms"]))
    kernels = []
    for name, src, replaces, key, launches, err, ms, plain_ms in rows:
        bound_ms, bound_by = bounds[key]
        check(bound_ms <= ms, f"{key}: {ms:.6f} ms is under its bound {bound_ms:.6f} ms: the "
                              "bound counts work the kernel does not do")
        kernels.append({"name": name, "route": "cuda", "source": f"celeste_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    tmp_dir.cleanup()
    stop_children()
    print(f"[done] whole script {time.perf_counter() - t_start:.3f} s", flush=True)
    lost = {k: sum(r["lost_s"] for r in k1_rows if r["kernel"] == k) for k in ("K1-fwd", "K1-bwd")}
    print(json.dumps({"k1_shapes": k1_rows, "k1_lost_s": lost}), flush=True)
    print(json.dumps({"k7_shapes": k7_rows, "k7_lost_s": sum(r["lost_s"] for r in k7_rows)}),
          flush=True)
    print(json.dumps({"large_c": large_c}), flush=True)
    print(json.dumps({"large_tile": large_tile}), flush=True)
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
