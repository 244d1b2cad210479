"""BASELINE config 5, the crowded field: 12 overlapping sources (10 stars and
2 galaxies) on a 48x128 r-band field, block-sparse tiled likelihood, sampled
by a chain ensemble.

Counterpart of ``celeste_tpu/bench/config5.py``: the same scene (positions
from ``default_rng(11)``, counts from seed 55 through the NumPy oracle, so
the counts are bitwise the JAX package's), the tiled-vs-dense parity gap,
the shared preparation flow (diagonal HMC warmup, a NUTS probe, the pooled
dense metric, z-space warmup) and the two whitened-space arms (ChEES and
NUTS).  Everything is batch-major; time is a Python loop.
:func:`build_config5_multiband` gives the same scene observed jointly in
several bands (g, r, i by default), :func:`build_config5_sharded` its
rectangular posterior sharded over a mesh of ranks.  The warm starts can
be cached (``config5_warmup_and_whiten_cached``, and ``measure_chees_z``'s
``warm_cache_path``): a file under ``celeste_tpu_torch/_cache/`` (not
committed) holds the warmed ensembles, trusted only when its fingerprint
matches and a live evaluation reproduces its saved log-densities.
"""

from __future__ import annotations

import os
import sys
import time
import zipfile

import numpy as np
import torch

N_SOURCES = 12
SHAPE = (48, 128)
GALAXIES = (3, 8)
N_BUCKETS = 2           # tile occupancy buckets of the tiled likelihood
MULTIBAND = (1, 2, 3)   # the joint field's bands: g, r, i
# the flow's fixed settings (the JAX bench's): HMC warmup windows, the first
# step size, ChEES adaptation windows and trajectory cap, the NUTS arm's
# depth, and one seed per phase
WARMUP_WINDOW = 50
INIT_STEP_SIZE = 0.1
CHEES_WINDOW = 20
MAX_LEAPFROG = 64
NUTS_MAX_DEPTH = 5
SEED_PREP, SEED_CHEES_WARM, SEED_CHEES, SEED_NUTS = 0, 11, 12, 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _gen(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _scene(bands, device):
    """The config-5 scene observed in ``bands``: (kinds, sources, the
    synthetic scene with one stamp per band)."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    rng = np.random.default_rng(11)
    cosd = np.cos(np.deg2rad(10.0))
    h, w = SHAPE
    kinds = tuple("galaxy" if i in GALAXIES else "star" for i in range(N_SOURCES))
    srcs = []
    # overlapping: 12 sources in a 30x15-arcsec core, mean separation ~3 px
    for i in range(N_SOURCES):
        px_, py_ = rng.uniform(34, 94), rng.uniform(12, 36)
        de, dn = (px_ - (w - 1) / 2) * 0.396, (py_ - (h - 1) / 2) * 0.396
        u = (30 + de / 3600 / cosd, 10 + dn / 3600)
        if kinds[i] == "star":
            srcs.append(star_source(u=u, flux_r=20 + 10 * rng.random()))
        else:
            srcs.append(galaxy_source(u=u, flux_r=60.0, sigma=0.8, ab=0.6))
    return kinds, srcs, make_synthetic_stamp(srcs, shape=(h, w), bands=bands, seed=55,
                                             device=device)


def _positions_and_radii(kinds, srcs, sd, stamp, radii_scale):
    """Source pixel positions [S, 2] on ``stamp`` and per-block support
    radii: each galaxy component block truncated at its own scale and
    amplitude (sigma upper bound = 1.5x the truth); ``radii_scale`` scales
    the live radii (the parity gate's regression hook; negative entries
    mark dead blocks and stay put)."""
    from celeste_tpu_torch.model.galaxy import block_support_radii

    du = torch.as_tensor(np.stack([sd.wcs.equa2duas(s["u"]) for s in srcs]),
                         dtype=torch.float32, device=stamp.counts.device)
    pos_px = stamp.duas2pixel(du).cpu().numpy()
    psf_sig = float(np.sqrt(np.max(np.linalg.eigvalsh(stamp.psf.cov.cpu().numpy()))))
    radii = block_support_radii(kinds, psf_sigma_px=psf_sig, gal_sigma_px=1.5 * 0.8 / 0.396)
    if radii_scale != 1.0:
        radii = np.where(radii > 0, radii * radii_scale, radii)
    return pos_px, radii


def _truth(srcs, kinds, wcs, bands, device):
    """The ground-truth unconstrained state [D] (float32): per source its
    offsets, a log-flux per band and (galaxies) the shape slots."""
    parts = []
    for s, kind in zip(srcs, kinds):
        head = [wcs.equa2duas(s["u"]), np.log([s["flux"][b] for b in bands])]
        if kind == "galaxy":
            th, ab = s["theta_dev"], s["ab"]
            head.append([np.log(th / (1 - th)), np.log(s["sigma"]), np.log(ab / (1 - ab)),
                         s["phi"]])
        parts.append(np.concatenate(head))
    return torch.as_tensor(np.concatenate(parts), dtype=torch.float32, device=device)


def build_config5(radii_scale: float = 1.0, device="cuda"):
    """Returns ``(logd_tiled, logd_dense, vec, info)``: both joint
    log-densities ``[B, D] -> [B]`` (centered), the ground-truth
    unconstrained state ``vec`` [D] (float32, on ``device``) and ``info``
    with the pieces probes need (scene, stamp, positions, tile data, WCS,
    sources, oracle stamp, per-block radii).  ``radii_scale`` scales the
    live support radii (the parity gate's regression hook).  Runs on the
    card unless ``device="cpu"``; a CUDA device where CUDA is absent
    raises."""
    from celeste_tpu_torch.experiments import resolve_device
    from celeste_tpu_torch.parallel.crowded import (
        CrowdedScene, make_crowded_logdensity, make_tiled_crowded_logdensity,
    )

    device = resolve_device(str(device))
    kinds, srcs, sd = _scene((2,), device)
    cs = CrowdedScene(kinds=kinds, n_bands=1)
    stamp = sd.stamps[0]
    pos_px, radii = _positions_and_radii(kinds, srcs, sd, stamp, radii_scale)
    # centered: the summed log-posterior stays at O(chi^2 / 2) ~ 1e4, where
    # fp32 resolves ~1e-3 nats (uncentered it is ~5.6e6)
    logd, data = make_tiled_crowded_logdensity(cs, stamp, band=0, positions_px=pos_px,
                                               radii_px=radii, n_buckets=N_BUCKETS,
                                               centered=True)
    logd_dense = make_crowded_logdensity(cs, [stamp], bands=[0], centered=True)
    vec = _truth(srcs, kinds, sd.wcs, (2,), device)
    info = {"scene": cs, "stamp": stamp, "positions_px": pos_px, "tiled_data": data,
            "wcs": sd.wcs, "sources": srcs, "oracle_stamp": sd.oracle_stamps[0],
            "radii": radii, "vec": vec}
    return logd, logd_dense, vec, info


def build_config5_multiband(bands=MULTIBAND, radii_scale: float = 1.0, device="cuda"):
    """Config 5 observed jointly in several bands: the same 12 sources,
    one 48x128 stamp and one tile map per band, a log-flux per band and
    source, so D = 10 (2 + nb) + 2 (6 + nb), 68 in three bands.  Stamp i
    takes flux slot i.  Returns ``(logd_tiled, logd_dense, vec, info)`` as
    :func:`build_config5` does, both log-densities centered (uncentered the
    three-band posterior is ~1.65e7, where fp32 resolves ~2 nats); ``info``
    has the scene, ``stamps``, positions, ``tiled_data`` (one per band),
    WCS, sources, ``bands``, ``oracle_stamps``, radii and ``vec``.
    ``radii_scale`` as in :func:`build_config5`.  Runs on the card unless
    ``device="cpu"``; a CUDA device where CUDA is absent raises."""
    from celeste_tpu_torch.experiments import resolve_device
    from celeste_tpu_torch.parallel.crowded import (
        CrowdedScene, make_crowded_logdensity, make_tiled_crowded_logdensity,
    )

    device = resolve_device(str(device))
    bands = tuple(bands)
    kinds, srcs, sd = _scene(bands, device)
    nb = len(bands)
    cs = CrowdedScene(kinds=kinds, n_bands=nb)
    stamps = list(sd.stamps)
    pos_px, radii = _positions_and_radii(kinds, srcs, sd, stamps[0], radii_scale)
    band_idx = list(range(nb))
    logd, datas = make_tiled_crowded_logdensity(cs, stamps, band=band_idx, positions_px=pos_px,
                                                radii_px=radii, n_buckets=N_BUCKETS,
                                                centered=True)
    logd_dense = make_crowded_logdensity(cs, stamps, bands=band_idx, centered=True)
    vec = _truth(srcs, kinds, sd.wcs, bands, device)
    info = {"scene": cs, "stamps": stamps, "positions_px": pos_px, "tiled_data": datas,
            "wcs": sd.wcs, "sources": srcs, "bands": bands, "oracle_stamps": sd.oracle_stamps,
            "radii": radii, "vec": vec}
    return logd, logd_dense, vec, info


def build_config5_sharded(info, mesh):
    """Config 5's rectangular posterior sharded over ``mesh`` (the sources
    over ``sources``, the chains over ``chains``; ``None`` for one rank).

    ``info`` is :func:`build_config5`'s.  The sharded tiling takes one
    support radius per source, the widest of its blocks, so galaxies keep
    all 16 component blocks in every tile they touch.  Returns a dict:
    ``logpost`` (rect [B, 12, 7] -> [B], the sharded tiled log-likelihood
    plus ``crowded_rect_logprior``, centered), ``loglik`` (the likelihood
    alone, with ``.buckets`` and ``.planes``), ``rect`` (the truth's
    rectangular state [12, 7]), ``logd_ref``, the single-device tiled
    posterior ``[B, 44] -> [B]`` built with the same radii, and ``scene``."""
    from celeste_tpu_torch.parallel.crowded import (
        crowded_rect_logprior, make_tiled_crowded_logdensity, sharded_tiled_crowded_loglik,
    )

    cs, stamp, pos = info["scene"], info["stamp"], info["positions_px"]
    radii = info["radii"].max(axis=1)
    loglik = sharded_tiled_crowded_loglik(cs, stamp, 0, mesh, pos, radii, n_buckets=N_BUCKETS,
                                          centered=True)
    logd_ref, _ = make_tiled_crowded_logdensity(cs, stamp, band=0, positions_px=pos,
                                                radii_px=radii, n_buckets=N_BUCKETS,
                                                centered=True)
    return {"logpost": lambda rect: loglik(rect) + crowded_rect_logprior(cs, rect),
            "loglik": loglik, "rect": cs.to_rect(info["vec"]), "logd_ref": logd_ref,
            "scene": cs}


def config5_parity_gap(logd_tiled, logd_dense, vec, n_probe=8, spread=0.01, seed=9):
    """Tiled vs dense log-posterior gap ``(gap_abs, gap_rel)`` on ``n_probe``
    states perturbed from ``vec`` with a NumPy seed.  The centered
    log-posterior is O(3e3), so the yardstick is absolute nats: fp32
    summation noise lands near 0.05, while dropped (source, tile) pairs cost
    hundreds to thousands.  The gate is gap_abs < 1.0."""
    rng = np.random.default_rng(seed)
    d = int(vec.shape[0])
    probe = vec[None, :] + torch.as_tensor(spread * rng.normal(size=(n_probe, d)),
                                           dtype=torch.float32, device=vec.device)
    with torch.no_grad():
        lt = logd_tiled(probe).double().cpu().numpy()
        ld = logd_dense(probe).double().cpu().numpy()
    gap_abs = float(np.max(np.abs(lt - ld)))
    return gap_abs, gap_abs / float(np.max(np.abs(ld)))


def config5_warmup_and_whiten(logd, vec, n_chains=1024, n_warmup=150, n_zwarm=30,
                              probe_steps=16, warmup_window=WARMUP_WINDOW,
                              init_step_size=INIT_STEP_SIZE):
    """The shared config-5 preparation flow: windowed diagonal HMC warmup ->
    a short NUTS probe -> pooled ensemble covariance -> whitened space ->
    a short z-space warmup.  Every arm starts from its output.

    Returns a dict: the whitened log density ``logd_z`` and the maps
    ``to_x``/``to_z``, the z-space chain states ``states_z`` and step size
    ``step_z``, the x-space ``states_x``, ``step_size`` and ``inv_mass``, and
    the moments ``whiten_moments`` the maps were built from.
    ``warmup_window``: HMC warmup iterations per window; ``init_step_size``:
    the first step size (the three-band field starts at 0.03: from 0.1 its
    short warmup spends its first iterations recovering from divergences).
    """
    from celeste_tpu_torch.inference import (
        dense_metric_from_probe, hmc_warmup_finish, hmc_warmup_init, hmc_warmup_window,
    )

    device = vec.device
    gen = _gen(SEED_PREP, device)
    d = int(vec.shape[0])
    x0 = vec[None, :] + 0.01 * torch.randn((n_chains, d), generator=gen, device=device)
    t = time.perf_counter()
    with torch.no_grad():
        carry = hmc_warmup_init(x0, logd, init_step_size=init_step_size)
        for off in range(0, n_warmup, warmup_window):
            carry = hmc_warmup_window(gen, logd, carry, min(warmup_window, n_warmup - off),
                                      n_warmup=n_warmup, n_leapfrog=8)
        states, ss, im = hmc_warmup_finish(carry)
        step_size = float(torch.quantile(ss, 0.5))
        inv_mass = torch.mean(im, dim=0)
        _sync(device)
        print(f"# config5 tiled warmup: step_size={step_size:.4f} "
              f"({time.perf_counter() - t:.1f}s)", file=sys.stderr, flush=True)

        # a probe with the diagonal metric pools the ensemble covariance of
        # the dense metric (overlapping sources couple parameters across
        # sources; whitening lets the samplers take short paths)
        t = time.perf_counter()
        dense = dense_metric_from_probe(gen, logd, states, step_size, inv_mass,
                                        probe_steps=probe_steps, n_zwarm=n_zwarm, n_leapfrog=8)
        _sync(device)
    print(f"# config5 probe and z-warm {time.perf_counter() - t:.1f}s; "
          f"dense-metric step_size={dense['step_z']:.3f}", file=sys.stderr, flush=True)
    return {
        "d": d, "logd_z": dense["logd_z"], "to_x": dense["to_x"], "to_z": dense["to_z"],
        "states_z": dense["states_z"], "step_z": dense["step_z"],
        "states_x": states, "step_size": step_size, "inv_mass": inv_mass,
        "whiten_moments": dense["moments"],
    }


def prep_cache_path(name: str) -> str:
    """The warm-start cache file of a named bench scene:
    ``celeste_tpu_torch/_cache/<name>_prep.npz`` (listed in .gitignore)."""
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}_prep.npz")


def _prep_fingerprint(vec, n_chains, n_warmup, warmup_window, n_zwarm, probe_steps,
                      init_step_size):
    """Everything that shapes the warmup stream (the scene enters via vec)."""
    return {
        "vec_sum": float(np.sum(vec.detach().cpu().numpy(), dtype=np.float64)),
        "d": int(vec.shape[0]),
        "n_chains": int(n_chains), "n_warmup": int(n_warmup),
        "warmup_window": int(warmup_window), "n_zwarm": int(n_zwarm),
        "probe_steps": int(probe_steps), "init_step_size": float(init_step_size),
    }


def _fp_ok(saved, want) -> bool:
    if not isinstance(saved, dict) or set(saved) != set(want):
        return False
    for k, v in want.items():
        s = saved[k]
        if isinstance(v, float):
            if abs(float(s) - v) > 1e-6 * max(1.0, abs(v)):
                return False
        elif s != v:
            return False
    return True


def _live_probe_gap(logd_z, xs, saved_logps, n_probe=8):
    """Max |live logd_z - saved logp| over the first ``n_probe`` chains."""
    with torch.no_grad():
        live = logd_z(xs[:n_probe])
    return float((live.double() - saved_logps[:n_probe].double()).abs().max())


def config5_warmup_and_whiten_cached(logd, vec, cache_path, n_chains=1024, n_warmup=150,
                                     warmup_window=WARMUP_WINDOW, n_zwarm=30, probe_steps=16,
                                     init_step_size=INIT_STEP_SIZE, verbose=True):
    """``config5_warmup_and_whiten`` behind a warm-start cache file: the
    probe-and-warmup flow runs once, its output (whitening moments, the
    warmed ensembles, the adapted step sizes) is checkpointed, and later
    runs load it.

    Two validation layers before a cached prep is trusted:

    - a fingerprint of the warmup-stream inputs (scene via ``sum(vec)``,
      chain count, window sizes): a different scene or configuration falls
      through to a fresh warmup;
    - a LIVE log-density probe: the cached chain states carry their saved
      ``logp``; recomputing ``logd_z(x)`` on 8 chains must reproduce them
      to 1 nat.  A code change to the likelihood or whitening math silently
      invalidates any saved ensemble; this catches it and falls back to a
      fresh warmup (and re-saves), rather than measuring a stale posterior.

    The file holds plain arrays (m_hat, cov_hat, the states, scalars) via
    ``utils.checkpoint``; ``logd_z``/``to_x``/``to_z`` are rebuilt from the
    moments at load, so nothing callable is serialized.  A hit returns,
    bitwise, what was saved.
    """
    from celeste_tpu_torch.inference import whiten_logdensity
    from celeste_tpu_torch.inference.hmc import HMCState
    from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    d, device = int(vec.shape[0]), vec.device
    fp = _prep_fingerprint(vec, n_chains, n_warmup, warmup_window, n_zwarm, probe_steps,
                           init_step_size)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def states():
        return HMCState(x=zeros(n_chains, d), logp=zeros(n_chains), grad=zeros(n_chains, d))

    like = {"m_hat": zeros(d), "cov_hat": zeros(d, d), "states_z": states(),
            "states_x": states(), "inv_mass": zeros(d), "step_z": zeros(), "step_size": zeros()}
    if cache_path and os.path.exists(cache_path):
        try:
            blob, _, extra = load_checkpoint(cache_path, like)
            if not _fp_ok(extra.get("fp"), fp):
                raise ValueError(f"fingerprint mismatch: {extra.get('fp')!r} vs {fp!r}")
            logd_z, to_x, to_z = whiten_logdensity(logd, blob["m_hat"], blob["cov_hat"])
            # live probe: the saved logp must be reproduced by today's code
            gap = _live_probe_gap(logd_z, blob["states_z"].x, blob["states_z"].logp)
            if not np.isfinite(gap) or gap > 1.0:
                raise ValueError(f"stale cached prep: live logd_z probe off by {gap:.3g} nats")
            if verbose:
                print(f"# config5 prep cache HIT ({cache_path}, probe gap {gap:.3g} nats)",
                      file=sys.stderr, flush=True)
            return {
                "d": d, "logd_z": logd_z, "to_x": to_x, "to_z": to_z,
                "states_z": blob["states_z"], "step_z": float(blob["step_z"]),
                "states_x": blob["states_x"], "step_size": float(blob["step_size"]),
                "inv_mass": blob["inv_mass"], "probe_gap": gap,
                "whiten_moments": (blob["m_hat"], blob["cov_hat"]),
            }
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:   # invalid -> warmup
            print(f"# config5 prep cache MISS ({str(e)[:200]})", file=sys.stderr, flush=True)

    prep = config5_warmup_and_whiten(logd, vec, n_chains=n_chains, n_warmup=n_warmup,
                                     n_zwarm=n_zwarm, probe_steps=probe_steps,
                                     warmup_window=warmup_window, init_step_size=init_step_size)
    if cache_path:
        # persist the moments the transforms are rebuilt from, not the
        # closures, with the warmed ensembles and adapted scalars
        m_hat, cov_hat = prep["whiten_moments"]
        save_checkpoint(cache_path, {
            "m_hat": m_hat, "cov_hat": cov_hat, "states_z": prep["states_z"],
            "states_x": prep["states_x"], "inv_mass": prep["inv_mass"],
            "step_z": torch.tensor(prep["step_z"], dtype=torch.float32),
            "step_size": torch.tensor(prep["step_size"], dtype=torch.float32),
        }, step=0, extra={"fp": fp})
        if verbose:
            print(f"# config5 prep cache SAVED -> {cache_path}", file=sys.stderr, flush=True)
    return prep


def _arm_diagnostics(to_x, seg_samples, drop_frac: int = 4):
    """Unwhiten the z-space segments, drop the first 1/drop_frac of the
    draws, and return (ESS [D], split-R-hat [D]) as NumPy arrays."""
    from celeste_tpu_torch.inference.diagnostics import ess, split_rhat

    z = torch.cat(list(seg_samples), dim=1)
    kept = to_x(z)[:, z.shape[1] // drop_frac:]
    return ess(kept).cpu().numpy(), split_rhat(kept).cpu().numpy()


def _chees_warm(prep, warmup_iters, warmup_window, max_leapfrog=MAX_LEAPFROG):
    """Windowed ChEES (eps, T) adaptation on the prepared ensemble, in
    windows of ``warmup_window`` iterations.  Returns ``(ChEESState, eps,
    traj)``."""
    from celeste_tpu_torch.inference import (
        chees_warmup_finish, chees_warmup_init, chees_warmup_window,
    )

    logd_z = prep["logd_z"]
    device = prep["states_z"].x.device
    gen = _gen(SEED_CHEES_WARM, device)
    t = time.perf_counter()
    carry = chees_warmup_init(prep["states_z"].x, logd_z, init_step_size=prep["step_z"])
    for off in range(0, warmup_iters, warmup_window):
        carry = chees_warmup_window(gen, logd_z, carry,
                                    n_iters=min(warmup_window, warmup_iters - off),
                                    init_step_size=prep["step_z"], max_leapfrog=max_leapfrog)
    st, eps, traj = chees_warmup_finish(carry)
    eps, traj = float(eps), float(traj)
    _sync(device)
    print(f"# config5 ChEES warmup: eps={eps:.3f} traj={traj:.3f} "
          f"(~{traj / eps:.0f} leaps; {time.perf_counter() - t:.1f}s)",
          file=sys.stderr, flush=True)
    return st, eps, traj


def _chees_warm_cached(prep, cache_path, warmup_iters, warmup_window,
                       max_leapfrog=MAX_LEAPFROG, verbose=True):
    """``_chees_warm`` behind a warm-start cache file, with the two
    validation layers of ``config5_warmup_and_whiten_cached``: a
    fingerprint of the adaptation-stream inputs, and a live ``logd_z``
    probe against the saved per-chain logps, so a likelihood or whitening
    code change falls back to a fresh adaptation instead of measuring a
    stale ensemble.  Returns ``(ChEESState, eps, traj)``."""
    from celeste_tpu_torch.inference.chees import ChEESState
    from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    z0 = prep["states_z"].x
    n_chains, d = int(z0.shape[0]), int(z0.shape[1])
    fp = {
        "z_sum": float(np.sum(z0.cpu().numpy(), dtype=np.float64)),
        "d": d, "n_chains": n_chains, "warmup_iters": int(warmup_iters),
        "warmup_window": int(warmup_window), "max_leapfrog": int(max_leapfrog),
        "step_z": float(prep["step_z"]),
    }

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=z0.device)

    like = {"st": ChEESState(xs=zeros(n_chains, d), logps=zeros(n_chains),
                             grads=zeros(n_chains, d)),
            "eps": zeros(), "traj": zeros()}
    if cache_path and os.path.exists(cache_path):
        try:
            blob, _, extra = load_checkpoint(cache_path, like)
            if not _fp_ok(extra.get("fp"), fp):
                raise ValueError(f"fingerprint mismatch: {extra.get('fp')!r} vs {fp!r}")
            gap = _live_probe_gap(prep["logd_z"], blob["st"].xs, blob["st"].logps)
            if not np.isfinite(gap) or gap > 1.0:
                raise ValueError(f"stale cached chees warm: live logd_z probe off by "
                                 f"{gap:.3g} nats")
            if verbose:
                print(f"# config5 chees warm cache HIT ({cache_path}, probe gap {gap:.3g} "
                      f"nats)", file=sys.stderr, flush=True)
            return blob["st"], float(blob["eps"]), float(blob["traj"])
        except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:   # invalid -> warmup
            print(f"# config5 chees warm cache MISS ({str(e)[:200]})", file=sys.stderr,
                  flush=True)
    with torch.no_grad():
        st, eps, traj = _chees_warm(prep, warmup_iters, warmup_window, max_leapfrog)
    if cache_path:
        save_checkpoint(cache_path, {"st": st,
                                     "eps": torch.tensor(eps, dtype=torch.float32),
                                     "traj": torch.tensor(traj, dtype=torch.float32)},
                        step=0, extra={"fp": fp})
        if verbose:
            print(f"# config5 chees warm cache SAVED -> {cache_path}", file=sys.stderr,
                  flush=True)
    return st, eps, traj


def measure_chees_z(prep, n_steps=240, run_segment=48, warmup_iters=60,
                    warmup_window=CHEES_WINDOW, max_leapfrog=MAX_LEAPFROG,
                    warm_cache_path=None):
    """Whitened-space ChEES-HMC arm: windowed ensemble warmup adapts
    (eps, T) in windows of ``warmup_window`` iterations (behind the cache
    file ``warm_cache_path`` when given), then frozen-parameter jittered-HMC
    segments of ``run_segment`` steps.  Returns a dict: ``min_ess_per_s`` (min ESS over
    the run's wall, the warmup excluded), ``accept``, ``n_leapfrog`` (mean
    per step), ``divergence``, ``max_rhat``, ``wall_s``, ``eps``, ``traj``
    and the x-space ``ess`` / ``rhat`` arrays."""
    from celeste_tpu_torch.inference import run_chees_ensemble

    logd_z = prep["logd_z"]
    device = prep["states_z"].x.device
    st, eps, traj = _chees_warm_cached(prep, warm_cache_path, warmup_iters, warmup_window,
                                       max_leapfrog)
    with torch.no_grad():
        gen = _gen(SEED_CHEES, device)
        t = time.perf_counter()
        seg_samples, infos = [], []
        for i in range(n_steps // run_segment):
            samples, st, info = run_chees_ensemble(gen, logd_z, st, n_steps=run_segment,
                                                   step_size=eps, trajectory_length=traj,
                                                   max_leapfrog=max_leapfrog,
                                                   start_iter=i * run_segment)
            seg_samples.append(samples)
            infos.append(info)
        _sync(device)
        dt = time.perf_counter() - t
        e, rh = _arm_diagnostics(prep["to_x"], seg_samples)
    out = {
        "min_ess_per_s": float(e.min() / dt), "wall_s": dt, "eps": eps, "traj": traj,
        "accept": _mean(infos, "accept_rate"), "n_leapfrog": _mean(infos, "n_leapfrog"),
        "divergence": _mean(infos, "divergence_rate"), "max_rhat": float(rh.max()),
        "ess": e, "rhat": rh,
        "finite": all(bool(torch.isfinite(s).all()) for s in seg_samples),
    }
    print(f"# config5 ChEES(z): {dt:.2f}s, min ESS/sec {out['min_ess_per_s']:.1f}, "
          f"median {float(np.median(e) / dt):.1f}, accept {out['accept']:.3f}, "
          f"mean leaps {out['n_leapfrog']:.1f}, divergence {out['divergence']:.4f}, "
          f"max rhat {out['max_rhat']:.4f}", file=sys.stderr, flush=True)
    return out


def measure_nuts_z(prep, n_steps=64, run_segment=16):
    """Whitened-space NUTS arm on the prepared ensemble, in segments of
    ``run_segment`` steps.  Returns a dict: ``min_ess_per_s``,
    ``divergence``, ``tree_depth`` (mean), ``accept``, ``n_leapfrog`` (mean
    per step), ``max_rhat``, ``wall_s`` and the x-space ``ess`` / ``rhat``
    arrays."""
    from celeste_tpu_torch.inference import nuts_kernel, run_chains_ensemble

    device = prep["states_z"].x.device
    kern = nuts_kernel(prep["logd_z"], step_size=prep["step_z"],
                       inv_mass=torch.ones(prep["d"], device=device), max_depth=NUTS_MAX_DEPTH)
    gen = _gen(SEED_NUTS, device)
    with torch.no_grad():
        t = time.perf_counter()
        seg_samples, infos = [], []
        cur = prep["states_z"]
        for _ in range(n_steps // run_segment):
            samples, cur, info = run_chains_ensemble(gen, kern, cur, n_steps=run_segment)
            seg_samples.append(samples)
            infos.append(info)
        _sync(device)
        dt = time.perf_counter() - t
        e, rh = _arm_diagnostics(prep["to_x"], seg_samples)
    out = {
        "min_ess_per_s": float(e.min() / dt), "wall_s": dt,
        "divergence": _mean(infos, "diverged"), "tree_depth": _mean(infos, "tree_depth"),
        "accept": _mean(infos, "accept_prob"), "n_leapfrog": _mean(infos, "n_leapfrog"),
        "max_rhat": float(rh.max()), "ess": e, "rhat": rh,
        "finite": all(bool(torch.isfinite(s).all()) for s in seg_samples),
    }
    print(f"# config5 NUTS(z): {dt:.2f}s, min ESS/sec {out['min_ess_per_s']:.1f}, "
          f"median {float(np.median(e) / dt):.1f}, divergence {out['divergence']:.4f}, "
          f"mean depth {out['tree_depth']:.2f}, max rhat {out['max_rhat']:.4f}",
          file=sys.stderr, flush=True)
    return out


def _mean(infos, field):
    """Mean of an info field over every segment, on the host."""
    return float(np.mean([getattr(i, field).double().mean().item() for i in infos]))
