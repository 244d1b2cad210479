"""The benchmark's stages (counterpart of ``bench.py:469-922``), one function
each, at ``bench.py``'s own settings, on the port's entry points.

Each stage takes the device first and returns a dict of metrics under
``BENCH_r05.json``'s keys where their meaning carries over
(``evals_per_sec_pallas`` and ``evals_per_sec_jnp`` become
``evals_per_sec_kernel`` and ``evals_per_sec_plain``).  The keyword
arguments are ``bench.py``'s settings; the CPU tests pass smaller ones.
Progress goes to stderr.  ``python -m celeste_tpu_torch.bench`` runs them
in ``bench.py``'s order (``STAGES``).

The oracle denominators carry over from BASELINE.md rows 13-17: they were
measured on a CPU with the NumPy oracle, and the ``*_vs_oracle`` ratios
divide by them.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from celeste_tpu_torch.bench.config5 import _sync

ORACLE_EVAL_RATE = 1.06e4             # evals/s, NumPy oracle (BASELINE.md)
ORACLE_CROWDED_ESS_RATE = 6.0         # min ESS/s, oracle slice, 6-star D=18 field
# min ESS/s of the oracle slice sampler on config 5 (12 mixed sources, D=44):
# scripts/oracle_config5_results.json, ess_per_sec_min
ORACLE_CONFIG5_ESS_RATE = 0.013313173316419125
# targets/s of the oracle slice-within-PT on config 4's workload:
# scripts/oracle_photoz_results.json, targets_per_sec
ORACLE_PHOTOZ_RATE = 0.05492205805232954

_COSD = np.cos(np.deg2rad(10.0))


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def evals(device, n: int = 65536, iters: int = 30, trials: int = 3, loop_k: int = 64):
    """Config 1's stamp log-likelihood at B = ``n`` chains (``bench.py``
    ``_bench_evals_per_sec``): the rate through the kernel
    (``batched_stamp_loglik``) and through its plain version, each the best
    of ``trials`` loops of ``iters`` calls; then ``loop_k`` kernel calls
    back to back on the card with no host launch between them, a CUDA graph
    (the counterpart of JAX's on-device loop; on the CPU a loop of calls).
    ``value`` is the best rate."""
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.kernels import mog_field as mf

    src = star_source(u=(30.0001, 9.9999), flux_r=25.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=3, device=device)
    stamp = scene.stamps[0]
    base = np.concatenate([scene.wcs.equa2duas(src["u"]), np.log(src["flux"])])
    rng = np.random.default_rng(0)
    vecs = torch.as_tensor((base[None, :] + 0.05 * rng.normal(size=(n, 7))).astype(np.float32),
                           device=device)
    pd = mf.stamp_pixel_data(stamp)
    fns = {
        "kernel": lambda: mf.batched_stamp_loglik(vecs, stamp, band=2, kind="star",
                                                  pixel_data=pd),
        "plain": lambda: mf._loglik_torch(*mf._field_planes(vecs, stamp, 2, "star", 5), *pd),
    }
    out = {}
    for name, fn in fns.items():
        fn()
        _sync(device)
        rate = 0.0
        for _ in range(trials):
            t = time.perf_counter()
            for _ in range(iters):
                res = fn()
            _sync(device)
            rate = max(rate, n * iters / (time.perf_counter() - t))
        if not bool(torch.isfinite(res).all()):
            raise RuntimeError(f"evals: non-finite log-likelihoods through the {name} path")
        _log(f"evals/sec {name}: {rate:.6e} (best of {trials})")
        out[f"evals_per_sec_{name}"] = rate
    if torch.device(device).type == "cuda":
        ms = graph_ms(fns["kernel"], reps=loop_k, trials=trials)
    else:
        t = time.perf_counter()
        for _ in range(loop_k):
            fns["kernel"]()
        ms = (time.perf_counter() - t) * 1e3 / loop_k
    out["evals_per_sec_device_loop"] = n / (ms * 1e-3)
    _log(f"evals/sec kernel, {loop_k} calls back to back: {out['evals_per_sec_device_loop']:.6e}")
    out["metric"] = "single-stamp likelihood evals/sec/chip"
    out["unit"] = "evals/s"
    out["value"] = max(out["evals_per_sec_kernel"], out["evals_per_sec_device_loop"])
    out["vs_baseline"] = out["value"] / ORACLE_EVAL_RATE
    return out


def config5_tiled(device, n_chains: int = 1024, n_warmup: int = 150, warmup_window: int = 50,
                  n_zwarm: int = 30, probe_steps: int = 16, chees_warmup_iters: int = 60,
                  chees_steps: int = 240, chees_segment: int = 48, nuts_steps: int = 32,
                  nuts_segment: int = 16):
    """Config 5 as written (``bench.py`` ``_bench_config5_tiled``): 12
    overlapping sources, 1024 chains, the tiled likelihood; the tiled-dense
    parity gate; the shared preparation and the ChEES arm's warm state
    behind the port's own warm-start caches (``bench/config5.py``
    ``prep_cache_path``); then the whitened ChEES and NUTS arms."""
    from celeste_tpu_torch.bench import config5 as c5

    logd, logd_dense, vec, _ = c5.build_config5(device=device)
    gap, gap_rel = c5.config5_parity_gap(logd, logd_dense, vec)
    out = {"tiled_dense_parity": gap, "tiled_dense_parity_rel": gap_rel,
           "tiled_dense_parity_ok": bool(gap < 1.0)}
    _log(f"config5 tiled-dense parity {gap:.6g} (rel {gap_rel:.3e})")
    prep = c5.config5_warmup_and_whiten_cached(
        logd, vec, c5.prep_cache_path("config5"), n_chains=n_chains, n_warmup=n_warmup,
        warmup_window=warmup_window, n_zwarm=n_zwarm, probe_steps=probe_steps)
    chees = c5.measure_chees_z(prep, n_steps=chees_steps, run_segment=chees_segment,
                               warmup_iters=chees_warmup_iters,
                               warm_cache_path=c5.prep_cache_path("config5_chees"))
    out["ess_per_sec_tiled_chees"] = chees["min_ess_per_s"]
    out["ess_vs_oracle_config5_chees"] = chees["min_ess_per_s"] / ORACLE_CONFIG5_ESS_RATE
    nuts = c5.measure_nuts_z(prep, n_steps=nuts_steps, run_segment=nuts_segment)
    out["ess_per_sec_tiled"] = nuts["min_ess_per_s"]
    out["tiled_divergence_frac"] = nuts["divergence"]
    out["ess_vs_oracle_config5"] = nuts["min_ess_per_s"] / ORACLE_CONFIG5_ESS_RATE
    return out


def crowded_ess(device, n_chains: int = 256, n_warmup: int = 200, n_steps: int = 200,
                chees_warmup_iters: int = 100, max_leapfrog: int = 64):
    """NUTS and ChEES min ESS/s on the 6-star crowded field, one band, D = 18
    (``bench.py`` ``_bench_ess_per_sec``): per-chain adaptive HMC warmup,
    then NUTS (depth 6) at the median step size and mean diagonal mass, timed
    on its one run; the ChEES arm whitens with the NUTS draws' pooled
    covariance, adapts (eps, T) and is timed on one run of 4x the steps."""
    from celeste_tpu_torch.bench.config5 import _arm_diagnostics
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.inference import (
        chees_warmup, ensemble_covariance, hmc_warmup, nuts_kernel, run_chains_ensemble,
        run_chees_ensemble, whiten_logdensity,
    )
    from celeste_tpu_torch.parallel import CrowdedScene, make_crowded_logdensity
    from celeste_tpu_torch.utils.rng import seeded_generator

    offs = [(-3, -2), (2.5, 1.5), (0, 2.5), (-2, 2), (3, -2.5), (0.5, -1)]
    srcs = [star_source(u=(30 + de / 3600 / _COSD, 10 + dn / 3600), flux_r=15 + 6 * i)
            for i, (de, dn) in enumerate(offs)]
    scene = make_synthetic_stamp(srcs, shape=(41, 41), bands=(2,), seed=31, device=device)
    logd = make_crowded_logdensity(CrowdedScene(kinds=("star",) * 6, n_bands=1),
                                   [scene.stamps[0]], bands=[0])
    vec = np.concatenate([np.concatenate([scene.wcs.equa2duas(s["u"]), [np.log(s["flux"][2])]])
                          for s in srcs])
    x0 = torch.as_tensor((vec[None, :] + 0.01 * np.random.default_rng(1).standard_normal(
        (n_chains, vec.size))).astype(np.float32), device=device)
    states, ss, im = hmc_warmup(seeded_generator(device, 3), logd, x0, n_warmup=n_warmup,
                                n_leapfrog=8)
    step_size = float(torch.median(ss))
    _log(f"crowded warmup: step_size={step_size:.6f}")
    kern = nuts_kernel(logd, step_size=step_size, inv_mass=im.mean(dim=0), max_depth=6)
    with torch.no_grad():
        t = time.perf_counter()
        samples, _, info = run_chains_ensemble(seeded_generator(device, 2), kern, states,
                                               n_steps=n_steps)
        _sync(device)
        dt = time.perf_counter() - t
    e, _ = _arm_diagnostics(lambda z: z, [samples])
    out = {"ess_per_sec_crowded": float(e.min() / dt)}
    out["ess_vs_oracle"] = out["ess_per_sec_crowded"] / ORACLE_CROWDED_ESS_RATE
    _log(f"crowded NUTS: {dt:.3f}s, min ESS/sec {out['ess_per_sec_crowded']:.6g}, divergence "
         f"frac {float(info.diverged.float().mean()):.4f}")
    m_hat, cov_hat = ensemble_covariance(samples[:, n_steps // 4::4], ridge=1e-4)
    logd_z, to_x, to_z = whiten_logdensity(logd, m_hat, cov_hat)
    st_c, eps_c, traj_c = chees_warmup(seeded_generator(device, 8), logd_z, to_z(states.x),
                                       n_warmup=chees_warmup_iters, init_step_size=0.3,
                                       max_leapfrog=max_leapfrog)
    eps_c, traj_c = float(eps_c), float(traj_c)
    with torch.no_grad():
        t = time.perf_counter()
        samples_z, _, info_c = run_chees_ensemble(seeded_generator(device, 10), logd_z, st_c,
                                                  n_steps=4 * n_steps, step_size=eps_c,
                                                  trajectory_length=traj_c,
                                                  max_leapfrog=max_leapfrog)
        _sync(device)
        dt_c = time.perf_counter() - t
    ec, rh = _arm_diagnostics(to_x, [samples_z])
    out["ess_per_sec_crowded_chees"] = float(ec.min() / dt_c)
    out["ess_vs_oracle_chees"] = out["ess_per_sec_crowded_chees"] / ORACLE_CROWDED_ESS_RATE
    _log(f"crowded ChEES: {dt_c:.3f}s, min ESS/sec {out['ess_per_sec_crowded_chees']:.6g}, "
         f"accept {float(info_c.accept_rate.mean()):.4f}, eps {eps_c:.4f}, traj {traj_c:.4f}, "
         f"max rhat {float(rh.max()):.4f}")
    return out


def photoz_batch(device, n_targets: int = 256, n_steps: int = 400, n_warmup: int = 150,
                 segment_steps: int = 100):
    """Config 4 at batch scale (``bench.py`` ``_bench_photoz_batch``): 256
    quasar photo-z tempered posteriors (6 temperatures, hmc_adaptive) in one
    batch, sampled in segments; targets/s over the whole wall, the steady
    rate from the segments after the first, and the z-recovery."""
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, project_to_bands, run_photo_z_batch_segmented,
        sdss_like_filterbank,
    )

    basis, filters = QuasarBasis.default(device), sdss_like_filterbank(n_pts=64, device=device)
    rng = np.random.default_rng(17)
    z_true = rng.uniform(0.5, 4.0, n_targets)
    ws = rng.dirichlet(np.ones(basis.n_basis), size=n_targets)
    f_clean = project_to_bands(basis, filters, torch.as_tensor(ws, dtype=torch.float32,
                                                               device=device), 2.0,
                               torch.as_tensor(z_true, dtype=torch.float32, device=device))
    f_clean = f_clean.cpu().numpy()
    flux, err = [], []
    for i in range(n_targets):
        e = 0.03 * np.abs(f_clean[i]) + 1e-5
        flux.append(f_clean[i] + rng.normal(size=e.shape) * e)
        err.append(e)
    flux, err = np.stack(flux).astype(np.float32), np.stack(err).astype(np.float32)
    cfg = PhotoZConfig(n_temps=6, n_steps=n_steps, n_warmup=n_warmup, n_systems=1,
                       inner="hmc_adaptive")
    t = time.perf_counter()
    res = run_photo_z_batch_segmented(5, basis, filters, flux, err, cfg,
                                      segment_steps=segment_steps, device=device)
    _sync(device)
    dt = time.perf_counter() - t
    z_med = np.median(res["z"].cpu().numpy().reshape(n_targets, -1), axis=1)
    out = {"photoz_targets_per_sec": n_targets / dt,
           "photoz_vs_oracle": n_targets / dt / ORACLE_PHOTOZ_RATE,
           "photoz_z_recovery_frac": float(np.mean(np.abs(z_med - z_true) < 0.25)),
           "photoz_batch_n": n_targets}
    seg_s = res["timings"]["segment_s"]
    if len(seg_s) >= 2:
        steady = n_targets / (float(np.mean(seg_s[1:])) * len(seg_s))
        out["photoz_targets_per_sec_steady"] = steady
        out["photoz_vs_oracle_steady"] = steady / ORACLE_PHOTOZ_RATE
    _log(f"photo-z batch ({n_targets} targets, 6 temperatures, hmc_adaptive): {dt:.3f}s "
         f"({res['n_steps_done']}/{n_steps} steps), {n_targets / dt:.6g} targets/s, "
         f"z-recovery {out['photoz_z_recovery_frac']:.4f}")
    return out


def tiled_field(device, n_src: int = 64, shape=(128, 512), n_chains: int = 1024,
                n_buckets: int = 3, calls: int = 20):
    """The occupancy-bucketed tiled likelihood on a 64-star 128x512 field at
    1024 chains (``bench.py`` ``_bench_tiled_field``): field evaluations per
    second over ``calls`` calls."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.kernels.tiled_field import (
        TiledStampData, scene_planes_padded, tiled_field_loglik,
    )
    from celeste_tpu_torch.parallel import CrowdedScene
    from celeste_tpu_torch.parallel.tiles import build_tile_map

    rng = np.random.default_rng(3)
    h, w = shape
    srcs = []
    for _ in range(n_src):
        px, py = rng.uniform(10, w - 10), rng.uniform(6, h - 6)
        de, dn = (px - (w - 1) / 2) * 0.396, (py - (h - 1) / 2) * 0.396
        srcs.append(star_source(u=(30 + de / 3600 / _COSD, 10 + dn / 3600),
                                flux_r=15 + 10 * rng.random()))
    sd = make_synthetic_stamp(srcs, shape=(h, w), bands=(2,), seed=77, device=device)
    scene = CrowdedScene(kinds=("star",) * n_src, n_bands=5)
    stamp = sd.stamps[0]
    pos_px = np.stack([stamp.duas2pixel(torch.as_tensor(sd.wcs.equa2duas(s["u"]),
                                                        dtype=torch.float32, device=device))
                       .cpu().numpy() for s in srcs])
    data = TiledStampData(build_tile_map(pos_px, radii_px=12.0, shape=(h, w)), stamp,
                          n_buckets=n_buckets)
    vec = np.concatenate([np.concatenate([sd.wcs.equa2duas(s["u"]), np.log(s["flux"])])
                          for s in srcs])
    vecs = torch.as_tensor((vec[None, :] + 0.01 * np.random.default_rng(0).normal(
        size=(n_chains, vec.size))).astype(np.float32), device=device)
    planes = scene_planes_padded(scene, vecs, stamp, 2)
    with torch.no_grad():
        res = tiled_field_loglik(planes, data, n_comp=3)
        _sync(device)
        t = time.perf_counter()
        for _ in range(calls):
            res = tiled_field_loglik(planes, data, n_comp=3)
        _sync(device)
        dt = time.perf_counter() - t
    if not bool(torch.isfinite(res).all()):
        raise RuntimeError("tiled_field: non-finite log-likelihoods")
    rate = n_chains * calls / dt
    _log(f"tiled field ({n_src} sources, {h}x{w}, {n_buckets} buckets): {rate:.6e} field-evals/s")
    return {"tiled_field_evals_per_sec": rate}


def config5_multiband(device, n_chains: int = 1024, n_warmup: int = 150,
                      warmup_window: int = 50, n_zwarm: int = 30, probe_steps: int = 16,
                      chees_warmup_iters: int = 60, chees_steps: int = 192,
                      chees_segment: int = 48):
    """Config 5 in three bands (g, r, i), D = 68, 1024 chains, ChEES only
    (``bench.py`` ``_bench_config5_multiband``): the parity gate, the
    preparation from a step of 0.03 and the ChEES warm state behind the
    port's own caches, then the whitened ChEES arm."""
    from celeste_tpu_torch.bench import config5 as c5

    logd, logd_dense, vec, _ = c5.build_config5_multiband(device=device)
    gap, gap_rel = c5.config5_parity_gap(logd, logd_dense, vec)
    out = {"tiled_multiband_parity": gap, "tiled_multiband_parity_rel": gap_rel,
           "tiled_multiband_parity_ok": bool(gap < 1.0)}
    _log(f"config5 multiband parity {gap:.6g} (rel {gap_rel:.3e})")
    prep = c5.config5_warmup_and_whiten_cached(
        logd, vec, c5.prep_cache_path("config5_multiband"), n_chains=n_chains,
        n_warmup=n_warmup, warmup_window=warmup_window, n_zwarm=n_zwarm,
        probe_steps=probe_steps, init_step_size=0.03)
    chees = c5.measure_chees_z(prep, n_steps=chees_steps, run_segment=chees_segment,
                               warmup_iters=chees_warmup_iters, warmup_window=20,
                               warm_cache_path=c5.prep_cache_path("config5_multiband_chees"))
    out["ess_per_sec_tiled_multiband_chees"] = chees["min_ess_per_s"]
    return out


def pipeline(device, n_chains: int = 32, n_warmup: int = 80, n_steps: int = 160,
             map_steps: int = 150, type_switch_steps: int | None = None):
    """The stamp catalog pipeline end to end, pixels to catalog (``bench.py``
    ``_bench_pipeline_walltime``): two stars and a galaxy on a 33x33 r-band
    stamp, 32 chains, 80 warmup and 160 steps, MAP fits of 150 steps, seed
    3 (``bench.py:909-910``, not the ``pipeline`` config's settings); its
    metrics stream goes to /dev/null.  ``type_switch_steps`` None keeps
    ``PipelineConfig``'s."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from celeste_tpu_torch.utils.metrics import MetricsLogger

    srcs = [star_source(u=(30.0 - 3.5 / 3600 / _COSD, 10.0 - 2.0 / 3600), flux_r=35.0),
            star_source(u=(30.0 + 3.0 / 3600 / _COSD, 10.0 + 2.5 / 3600), flux_r=25.0),
            galaxy_source(u=(30.0, 10.0), flux_r=70.0, sigma=1.8, ab=0.6)]
    scene = make_synthetic_stamp(srcs, shape=(33, 33), bands=(2,), seed=101, device=device)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    extra = {} if type_switch_steps is None else {"type_switch_steps": type_switch_steps}
    cfg = PipelineConfig(max_sources=5, n_chains=n_chains, n_warmup=n_warmup, n_steps=n_steps,
                         map_steps=map_steps, seed=3, detection_min_separation=7, **extra)
    with open(os.devnull, "w") as devnull:
        t = time.perf_counter()
        _, artifacts = run_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg, priors=priors,
                                    logger=MetricsLogger(stream=devnull))
        _sync(device)
        dt = time.perf_counter() - t
    _log(f"pipeline (3-source mixed field, detect + classify + sample): {dt:.3f}s wall, "
         f"{artifacts['n_sources']} sources")
    return {"pipeline_wall_time_s": dt}


# bench.py's order (bench.py:1009-1018)
STAGES = {"evals": evals, "config5_tiled": config5_tiled, "crowded_ess": crowded_ess,
          "photoz_batch": photoz_batch, "tiled_field": tiled_field,
          "config5_multiband": config5_multiband, "pipeline": pipeline}
