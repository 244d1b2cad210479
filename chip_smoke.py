#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``celeste_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no caught exception):

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels of ``celeste_tpu_torch/csrc`` with nvcc (sm_90a);
3. hold the forward kernel against its plain PyTorch version on the card:
   star (C=3) and galaxy (C=48) planes, B=1000 and 4096, centered both
   ways, a full mask and one with zeros; rtol 2e-6, atol 0.5 (galaxies 1.0),
   the tolerances of the JAX package's kernel tests;
4. hold the backward kernel against torch autograd through the plain
   version, rtol 5e-4, atol 5e-2, and check that a zero-amplitude component
   gives finite gradients;
5. drive the main path through its entry point, ``run_experiment`` of
   config 1 (``star_single``: 64 chains, one 25x25 r-band stamp) with MH as
   written and then with HMC, with every kernel launch counter set to 0
   just before and read just after; fail on max R-hat > 1.1, on a truth
   outside mean +- 5 std, or on a kernel the run never launched; check the
   card's log-likelihood at the truth against the fp64 NumPy oracle;
6. time the stamp log-likelihood at B=65536 chains on the 25x25 r-band
   stamp (kernel and plain version, best of 3 after a warm-up, CUDA events)
   and one HMC gradient at B=65536;
7. print the kernels' JSON line, the card line, and the result line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

FWD_TOL = {"star": (2e-6, 0.5), "galaxy": (2e-6, 1.0)}   # (rtol, atol)
BWD_TOL = (5e-4, 5e-2)
ORACLE_TOL = (2e-6, 1.0)
BENCH_CHAINS = 65536


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


def scenes(device):
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    star = make_synthetic_stamp([star_source(u=(30.0001, 9.9999), flux_r=25.0)],
                                shape=(25, 25), bands=(2,), seed=3, device=device)
    gal = make_synthetic_stamp([galaxy_source(u=(30.0, 10.0), flux_r=60.0)],
                               shape=(25, 25), bands=(2,), seed=5, device=device)
    return {"star": star, "galaxy": gal}


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


def kernel_checks(device):
    """Phases 3 and 4: each kernel against its plain version on the card."""
    from celeste_tpu_torch.kernels import mog_field as mf

    errs = {"fwd": 0.0, "bwd": 0.0}
    for kind, scene in scenes(device).items():
        stamp = scene.stamps[0]
        pd = mf.stamp_pixel_data(stamp)
        holed = pd[4].clone()
        holed[0, ::7] = 0.0
        masks = {"full": pd[4], "holed": holed}
        rtol, atol = FWD_TOL[kind]
        for b in (1000, 4096):
            vecs = torch.as_tensor(source_vecs(scene, kind, b, seed=b), device=device)
            planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 2, kind, 5)]
            for mname, mask in masks.items():
                pix = (*pd[:4], mask)
                for centered in (False, True):
                    got = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
                    want = mf._loglik_torch(*planes, *pix, centered=centered)
                    torch.cuda.synchronize()
                    what = f"fwd {kind} B={b} mask={mname} centered={centered}"
                    errs["fwd"] = max(errs["fwd"], max_abs_err(got, want, rtol, atol, what))
            g = torch.as_tensor(np.random.default_rng(b + 1).normal(size=b).astype(np.float32),
                                device=device)
            zero_amp = planes[0].clone()
            zero_amp[::5, 0] = 0.0
            for aname, amp in (("amp", planes[0]), ("zero-amp", zero_amp)):
                ps = [amp, *planes[1:]]
                pix = (*pd[:4], holed)
                got = mf.loglik_bwd_cuda(*ps, *pix, g)
                leaves = [t.detach().clone().requires_grad_(True) for t in ps]
                want = torch.autograd.grad(mf._loglik_torch(*leaves, *pix), leaves, g)
                torch.cuda.synchronize()
                for name, a, w in zip(("amp", "mx", "my", "pa", "pb", "pc"), got, want):
                    what = f"bwd {kind} B={b} {aname} d_{name}"
                    errs["bwd"] = max(errs["bwd"], max_abs_err(a, w, *BWD_TOL, what))
        print(f"[kernels] {kind}: forward and backward match the plain version", flush=True)
    return errs


def main_path(device):
    """Phase 5: config 1 through run_experiment, MH then HMC."""
    from celeste_tpu_torch.experiments import CONFIGS, run_experiment
    from celeste_tpu_torch.kernels import mog_field as mf

    runs = []
    for sampler, overrides in (("mh", {}), ("hmc", {"n_steps": 500, "n_warmup": 300})):
        cfg = copy.deepcopy(CONFIGS["star_single"])
        cfg.device, cfg.sampler = str(device), sampler
        for k, v in overrides.items():
            setattr(cfg, k, v)
        t0 = time.perf_counter()
        res = run_experiment(cfg)
        torch.cuda.synchronize()
        runs.append((sampler, cfg, res, time.perf_counter() - t0, dict(mf.launch_counts())))
    return runs


def report_run(sampler, cfg, res, seconds, counts_after):
    samples = res["samples"]
    check(samples.shape == (cfg.n_chains, cfg.n_steps, 3),
          f"{sampler}: samples shape {samples.shape}")
    check(bool(np.isfinite(samples).all()), f"{sampler}: non-finite samples")
    mean, std, x0 = res["mean"], res["std"], res["x0"]
    rhat_max, ess_min = float(np.max(res["rhat"])), float(np.min(res["ess"]))
    z = np.abs(mean - x0) / std
    print(f"[main path] star_single sampler={sampler} chains={cfg.n_chains} "
          f"steps={cfg.n_steps} warmup={cfg.n_warmup if sampler == 'hmc' else 0} "
          f"wall={seconds:.3f}s accept={res['accept_rate']:.4f} "
          f"step_size={res.get('step_size', 0.01)} max_rhat={rhat_max:.4f} "
          f"min_ess={ess_min:.1f} launches_so_far={counts_after}", flush=True)
    for name, m, s, t, zz in zip(("du_e", "du_n", "log_flux"), mean, std, x0, z):
        print(f"    {name}: {m:.6f} +- {s:.6f}  truth {t:.6f}  |z|={zz:.3f}", flush=True)
    check(rhat_max <= 1.1, f"{sampler}: max R-hat {rhat_max:.4f} > 1.1")
    check(bool(np.all(z <= 5.0)), f"{sampler}: truth outside mean +- 5 std (|z|={z})")


def oracle_check(device):
    """The card's log-likelihood at the truth against the fp64 NumPy oracle
    on the same synthetic stamp."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.kernels.mog_field import batched_stamp_loglik
    from celeste_tpu_torch.oracle.forward import oracle_poisson_loglik, oracle_star_lambda

    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=0, device=device)
    ost = scene.oracle_stamps[0]
    want = oracle_poisson_loglik(oracle_star_lambda(src["u"], src["flux"][2], ost),
                                 ost["counts"])
    x = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])]])
    got = batched_stamp_loglik(torch.as_tensor(x[None], dtype=torch.float32, device=device),
                               scene.stamps[0], band=0, kind="star", n_bands=1)
    err = max_abs_err(got.cpu(), torch.tensor([want]), *ORACLE_TOL, "loglik vs oracle")
    print(f"[oracle] loglik at truth: card {float(got[0]):.3f} oracle {want:.3f} "
          f"abs err {err:.4g}", flush=True)


def timings(device, card):
    """Phase 6: B=65536 chains on one 25x25 r-band stamp."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.inference.problems import make_star_logdensity
    from celeste_tpu_torch.kernels import mog_field as mf
    from celeste_tpu_torch.model.params import StarParams
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
    scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=0, device=device)
    stamp = scene.stamps[0]
    pd = mf.stamp_pixel_data(stamp)
    x0 = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])]])
    rng = np.random.default_rng(0)
    vecs = torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(BENCH_CHAINS, 3)))
                           .astype(np.float32), device=device)
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
    evals = {k: BENCH_CHAINS / (v * 1e-3) for k, v in t.items()}
    print(f"[timing] B={BENCH_CHAINS} chains, 25x25 r-band stamp, card: {card}", flush=True)
    for k, v in t.items():
        print(f"    {k} = {v:.6f} ms  ({evals[k]:.6e} chain-evals/s)", flush=True)
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from celeste_tpu_torch.kernels import mog_field as mf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = mf.build_kernels()
    print(f"[build] {lib.name} built and loaded in {time.perf_counter() - t0:.3f} s",
          flush=True)

    errs = kernel_checks(device)
    oracle_check(device)

    mf.reset_launch_counts()
    runs = main_path(device)
    counts = mf.launch_counts()
    for sampler, cfg, res, seconds, after in runs:
        report_run(sampler, cfg, res, seconds, after)
    check(runs[0][4]["mog_field_loglik_fwd"] > 0, "MH run never launched the forward kernel")
    for name, n in counts.items():
        check(n > 0, f"the main path never launched {name}")

    t = timings(device, card)
    kernels = [
        {"name": "mog_field_loglik_fwd", "route": "cuda",
         "source": "celeste_tpu_torch/csrc/mog_field.cu",
         "replaces": "celeste_tpu/kernels/mog_field.py:80",
         "launches": counts["mog_field_loglik_fwd"], "max_abs_err": errs["fwd"],
         "ms": t["fwd_ms"], "plain_ms": t["fwd_plain_ms"]},
        {"name": "mog_field_loglik_bwd", "route": "cuda",
         "source": "celeste_tpu_torch/csrc/mog_field.cu",
         "replaces": "celeste_tpu/kernels/mog_field.py:182",
         "launches": counts["mog_field_loglik_bwd"], "max_abs_err": errs["bwd"],
         "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
