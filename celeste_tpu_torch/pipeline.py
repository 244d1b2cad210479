"""End-to-end catalog inference pipeline, pixels to a posterior catalog
(counterpart of ``celeste_tpu/pipeline.py``).

Stages:
  1. detect   -- CLEAN-style iterative matched-filter detection: each round
                 fits a star MAP to the strongest peak of the residual and
                 subtracts its expected image;
  2. classify -- Jacobi sweeps of conditional classification: every
                 candidate is re-decided star / galaxy / absent against the
                 others of the previous sweep by Laplace evidence, then
                 deblender merging and evidence pruning;
  2b. type    -- the Carlin-Chib type sampler decides the candidates whose
                 last Laplace margin is ambiguous;
  3. sample   -- the whole scene jointly, dense-metric ChEES (or NUTS);
  4. catalog  -- posterior summaries per source in physical units;
  5. ppc      -- the posterior-predictive check (optional).

One Stamp or a list of per-band Stamps (detection on
``detect_band_index``; fits and sampling joint over all bands).  The host
decisions (detection, pruning, merging, the margin and extendedness rule,
the ambiguous band) are NumPy, line for line as the JAX package makes them.
The device work runs in the stamp kernels on the card: K1 (fused render +
Poisson log-likelihood, and its gradient) for every fit, evidence and
sampler step, K7 (render) for the CLEAN subtraction and the PPC.

The conditional posteriors (``Conditional``).  JAX gives candidate i an
effective sky, the sky plus every other alive candidate's expected image,
and evaluates i against it.  K1 takes one [1, P] sky per stamp, so here
the other alive candidates are folded into each row as fixed components
instead: row i's planes are its own components followed by every alive
candidate's (a star K components, a galaxy N_GAL x K), the amplitude zeroed
for i itself.  The function is the same, lambda = sky + sum_{j != i}
lambda_j + lambda_i(x), against the stamp's shared sky.  The star and the
galaxy fits of all candidates run as one [2N, 6 + B] rectangular batch
(``mixed_field_planes``), so every Adam step of a sweep is one K1-fwd and
one K1-bwd launch whatever N is, and the Laplace Hessians of the sweep are
one more (``model_select.hessian_fd``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from celeste_tpu_torch.inference import (
    chees_warmup,
    hmc_kernel,
    hmc_warmup,
    nuts_kernel,
    run_chains_ensemble,
    run_chees_ensemble,
    summarize,
)
from celeste_tpu_torch.inference.map_fit import detect_peaks, map_fit
from celeste_tpu_torch.inference.model_select import hessian_fd, laplace_from_hessian
from celeste_tpu_torch.inference.type_switch import sample_source_type_core
from celeste_tpu_torch.inference.whiten import ensemble_covariance, whiten_logdensity
from celeste_tpu_torch.kernels.mog_field import (
    _field_planes,
    mixed_field_planes,
    mog_field_loglik,
    mog_field_render,
    stamp_pixel_data,
)
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.priors import SourcePriors
from celeste_tpu_torch.mog import eval_grid
from celeste_tpu_torch.parallel.crowded import CrowdedScene, make_crowded_logdensity
from celeste_tpu_torch.utils.metrics import MetricsLogger
from celeste_tpu_torch.utils.rng import seeded_generator

# random streams (utils.rng paths under cfg.seed): the type switch's
# candidate i draws from (TYPE_SWITCH, i), as JAX folds 77 into its key; the
# joint sampling's start jitter, warmup, probe, ChEES warmup and run from
# (JOINT, 0..4)
TYPE_SWITCH, JOINT = 77, 1
GAL_SHAPE_INIT = np.array([0.0, 0.0, 0.0, 0.5], np.float32)


@dataclass
class PipelineConfig:
    max_sources: int = 8
    detection_snr_min: float = 5.0
    # peak exclusion radius (px).  Extended galaxies shed secondary peaks in
    # their wings; phantom candidates are handled by pruning/merging, but a
    # radius near the largest expected source extent keeps the candidate
    # list short.
    detection_min_separation: int = 5
    classify: bool = True
    # minimum Laplace-evidence gain (nats) over the source-free conditional
    # scene for a candidate to survive pruning
    prune_min_evidence: float = 5.0
    classify_sweeps: int = 3
    # star/galaxy decision: galaxy only when the galaxy model BOTH wins the
    # Laplace evidence by a margin AND fits a genuinely extended profile
    # (neighbour-model residuals in blends reward a quasi-point "galaxy")
    galaxy_margin_nats: float = 10.0
    galaxy_sigma_min_arcsec: float = 0.4
    merge_sigma_factor: float = 1.5
    # candidates whose last |Laplace margin| is inside galaxy_margin_nats
    # follow the Carlin-Chib sampler's P(star) on their conditional
    # posterior; clear-cut candidates keep the cheap rule
    type_switch: bool = True
    type_switch_chains: int = 8
    type_switch_steps: int = 300
    # posterior-predictive check stage (ppc.py)
    ppc: bool = False
    ppc_draws: int = 32
    n_chains: int = 32
    n_warmup: int = 250
    n_steps: int = 500
    n_leapfrog: int = 10
    max_depth: int = 6
    map_steps: int = 300
    seed: int = 0
    # joint-sampling kernel: chees (whitened ensemble-adaptive jittered HMC)
    # or nuts
    sampler: str = "chees"


@dataclass
class CatalogEntry:
    kind: str
    p_star: float
    du_mean: np.ndarray     # arcsec offsets (east, north)
    du_std: np.ndarray
    flux_mean: np.ndarray   # per band, nanomaggies
    flux_std: np.ndarray
    extras: dict = field(default_factory=dict)


def _sigmoid(x: float) -> float:
    return 0.5 * (1.0 + math.tanh(0.5 * x))


def kind_logprior(priors: SourcePriors, n_bands: int, kind: str, x, flags=None):
    """Prior + log|det J| of [N, D] source vectors of one kind: "star" (D =
    2 + B), "galaxy" (D = 6 + B) or "mixed" (the rectangular 6 + B layout,
    each row's kind in ``flags``, a star's shape slots inert)."""
    def star(v):
        return (priors.star_logpdf(StarParams.from_vector(v, n_bands))
                + StarParams.log_det_jacobian(v, n_bands))

    def galaxy(v):
        return (priors.galaxy_logpdf(GalaxyParams.from_vector(v, n_bands))
                + GalaxyParams.log_det_jacobian(v, n_bands))

    if kind == "star":
        return star(x)
    if kind == "galaxy":
        return galaxy(x)
    return torch.where(flags, star(x[..., :2 + n_bands]), galaxy(x))


class Conditional:
    """The candidates' conditional posteriors on a set of stamps: the
    others folded in as fixed components (module docstring).

    ``fold`` fixes the scene of a sweep (every alive candidate's planes);
    ``logdensity`` then builds the batched log density of a list of
    problems, each a candidate and a kind, whose rows come grouped by
    problem (any number of rows per problem: one per Adam fit, 2D + 1 per
    Hessian, one per chain)."""

    def __init__(self, stamps, bands, n_bands: int, priors: SourcePriors):
        self.stamps, self.bands, self.n_bands, self.priors = stamps, bands, n_bands, priors
        self.device = stamps[0].device
        self.pds = [stamp_pixel_data(st) for st in stamps]

    def fold(self, rects, is_star, alive):
        """Per stamp, the fixed planes (six [C_o] tensors) of every alive
        candidate, each by its kind's width (``mixed_field_planes``' first
        K columns for a star, all N_GAL x K for a galaxy), and each
        component's candidate index, [C_o]."""
        rects_t = torch.as_tensor(np.asarray(rects, np.float32), device=self.device)
        flags_t = torch.as_tensor(np.asarray(is_star, bool), device=self.device)
        out = []
        for st, b in zip(self.stamps, self.bands):
            planes = mixed_field_planes(rects_t, st, b, self.n_bands, flags_t)
            k, width = st.psf.n_components, planes[0].shape[1]
            rows, cols = [], []
            for i, (star, live) in enumerate(zip(is_star, alive)):
                if live:
                    w = k if star else width
                    rows += [i] * w
                    cols += range(w)
            rows_t = torch.as_tensor(rows, dtype=torch.long, device=self.device)
            cols_t = torch.as_tensor(cols, dtype=torch.long, device=self.device)
            out.append((tuple(p[rows_t, cols_t] for p in planes), rows_t))
        return out

    def _own_planes(self, kind, x, st, b, flags):
        if kind == "mixed":
            return mixed_field_planes(x, st, b, self.n_bands, flags)
        return _field_planes(x, st, b, kind, self.n_bands)

    def logdensity(self, kind: str, cands, folded, is_star=None):
        """The batched conditional log density ``[R, D] -> [R]`` of the
        problems ``cands`` (candidate indices), R a multiple of their count
        with problem p's rows consecutive.  ``kind``: "star" (D = 2 + B),
        "galaxy" (D = 6 + B) or "mixed" (the rectangular 6 + B layout, a
        star's shape slots inert; ``is_star`` per problem).  On the card,
        K1 refuses a row of more components (its own and the folded
        others') than it stages in shared memory, and its wrapper raises."""
        cands_t = torch.as_tensor(np.asarray(cands), dtype=torch.long, device=self.device)
        flags = (torch.as_tensor(np.asarray(is_star, bool), device=self.device)
                 if kind == "mixed" else None)
        # each problem's amplitude mask over the fixed components: 0 on its own
        keep = [(owner[None, :] != cands_t[:, None]).to(torch.float32) for _, owner in folded]
        n_prob = len(cands_t)

        def logd(x):
            k = x.shape[0] // n_prob
            rows_flags = flags.repeat_interleave(k) if flags is not None else None
            ll = 0.0
            for st, b, pd, (fixed, _), kp in zip(self.stamps, self.bands, self.pds, folded,
                                                  keep):
                own = self._own_planes(kind, x, st, b, rows_flags)
                others = (kp.repeat_interleave(k, dim=0) * fixed[0],) + tuple(
                    f.expand(x.shape[0], -1) for f in fixed[1:])
                planes = [torch.cat([o, f], dim=-1) for o, f in zip(own, others)]
                ll = ll + mog_field_loglik(*planes, pd)
            return ll + kind_logprior(self.priors, self.n_bands, kind, x, rows_flags)

        return logd

    def source_free(self, cands, folded):
        """lz_0 [N]: the uncentered log-likelihood of each candidate's
        conditional scene without the candidate (the others alone), one
        K1-fwd launch per stamp."""
        cands_t = torch.as_tensor(np.asarray(cands), dtype=torch.long, device=self.device)
        total = 0.0
        for pd, (fixed, owner) in zip(self.pds, folded):
            keep = (owner[None, :] != cands_t[:, None]).to(torch.float32)
            planes = [keep * fixed[0]] + [f.expand(len(cands_t), -1) for f in fixed[1:]]
            total = total + mog_field_loglik(*[p.contiguous() for p in planes], pd)
        return total

    def det_fit(self, x0, work, map_steps: int):
        """Detection-stage star MAP from ``x0`` [2 + B] on the residual
        counts ``work`` (one [H, W] array per stamp): K1 at one chain with
        the residual as its counts.  Returns (x_map [2 + B], the fit's
        sky-free expected image per stamp as [H, W] NumPy, from K7 with a
        zero sky)."""
        pds_res = []
        for pd, w in zip(self.pds, work):
            counts = torch.as_tensor(np.asarray(w, np.float32).ravel(), device=self.device)
            counts = F.pad(counts, (0, pd[0].shape[1] - counts.numel()))[None, :]
            pds_res.append((pd[0], pd[1], counts, pd[3], pd[4]))
        nb = self.n_bands

        def logd(x):
            ll = 0.0
            for st, b, pd in zip(self.stamps, self.bands, pds_res):
                ll = ll + mog_field_loglik(*_field_planes(x, st, b, "star", nb), pd)
            return ll + kind_logprior(self.priors, nb, "star", x)

        x_map, _ = map_fit(logd, x0[None], n_steps=map_steps)
        lams = []
        for st, b, pd in zip(self.stamps, self.bands, self.pds):
            zero_sky = (pd[0], pd[1], pd[2], torch.zeros_like(pd[3]), pd[4])
            lam = mog_field_render(*_field_planes(x_map, st, b, "star", nb), zero_sky)[0]
            h, w = st.counts.shape
            lams.append(lam[:h * w].reshape(h, w).cpu().numpy().astype(np.float64))
        return x_map[0], lams


def _rect_of(c, ds, dg):
    r = np.zeros(dg, np.float32)
    if c["kind"] == "star":
        r[:ds] = c["x"][:ds]
        r[ds:] = GAL_SHAPE_INIT      # galaxy-fit start for star candidates
    else:
        r[:] = c["x"]
    return r


def detect(cond: Conditional, cfg: PipelineConfig, detect_band_index: int = 0):
    """Stage 1, CLEAN-style: up to ``max_sources`` rounds of detect the
    strongest residual peak -> star MAP -> subtract.  Returns (star MAPs as
    NumPy [2 + B] vectors, the peaks' SNRs)."""
    stamps, n_bands = cond.stamps, cond.n_bands
    det = stamps[detect_band_index]
    psf_peak = float(eval_grid(det.psf, torch.zeros((), device=det.device),
                               torch.zeros((), device=det.device)))
    iota_det = float(det.iota)
    a_inv = np.linalg.inv(det.wcs_A.cpu().numpy().astype(np.float64))
    p0 = det.wcs_p0.cpu().numpy().astype(np.float64)

    work = [st.counts.cpu().numpy().astype(np.float64) for st in stamps]
    skies = [st.sky.cpu().numpy().astype(np.float64) for st in stamps]
    star_maps, snr_log = [], []
    for _ in range(cfg.max_sources):
        # the residual as a stamp's float32 counts, as JAX hands it over
        rs_det = SimpleNamespace(counts=work[detect_band_index].astype(np.float32),
                                 sky=det.sky, psf=det.psf)
        peaks, snrs = detect_peaks(rs_det, n_peaks=1,
                                   min_separation=cfg.detection_min_separation)
        if len(peaks) == 0 or snrs[0] < cfg.detection_snr_min:
            break
        px, py = peaks[0]
        du = a_inv @ (np.array([px, py]) - p0)
        peak_val = max(float(work[detect_band_index][int(py), int(px)]
                             - skies[detect_band_index][int(py), int(px)]), 1.0)
        flux0 = peak_val / (iota_det * psf_peak)
        x0 = torch.as_tensor(np.concatenate([du, np.full(n_bands, np.log(flux0))]),
                             dtype=torch.float32, device=cond.device)
        x_map, lams = cond.det_fit(x0, work, cfg.map_steps)
        for k, lam in enumerate(lams):
            work[k] = work[k] - lam
        star_maps.append(x_map.cpu().numpy())
        snr_log.append(float(snrs[0]))
    return star_maps, snr_log


def classify_sweep(cond: Conditional, cand, cfg: PipelineConfig):
    """One Jacobi sweep: every alive candidate's star fit and galaxy fit
    against the previous sweep's scene, as one batch of rows (one K1-fwd
    and one K1-bwd launch per Adam step), their Laplace evidences from one
    Hessian batch, and the source-free evidence.  Returns {candidate index:
    (x_star, lz_s, x_gal, lz_g, lz_0)} with NumPy vectors and floats."""
    nb = cond.n_bands
    ds, dg = 2 + nb, 6 + nb
    idx = [i for i, c in enumerate(cand) if c["alive"]]
    rects = np.stack([_rect_of(c, ds, dg) for c in cand])
    flags = [c["kind"] == "star" for c in cand]
    folded = cond.fold(rects, flags, [c["alive"] for c in cand])
    x0 = torch.as_tensor(rects[idx], device=cond.device)
    if cfg.classify:
        # rows: candidate idx[j]'s star fit (2 j) and galaxy fit (2 j + 1),
        # both from its rectangular state, as JAX starts them
        logd = cond.logdensity("mixed", np.repeat(idx, 2), folded,
                               is_star=[True, False] * len(idx))
        x_fit, _ = map_fit(logd, x0.repeat_interleave(2, dim=0), n_steps=cfg.map_steps)
        logp, h = hessian_fd(logd, x_fit)
        lz_s = laplace_from_hessian(logp[0::2], h[0::2, :ds, :ds])
        lz_g = laplace_from_hessian(logp[1::2], h[1::2])
        xs, xg = x_fit[0::2, :ds], x_fit[1::2]
    else:
        logd = cond.logdensity("star", idx, folded)
        xs, _ = map_fit(logd, x0[:, :ds], n_steps=cfg.map_steps)
        logp, h = hessian_fd(logd, xs)
        lz_s = laplace_from_hessian(logp, h)
        xg = torch.zeros_like(x0)
        lz_g = torch.full_like(lz_s, -math.inf)
    lz_0 = cond.source_free(idx, folded)
    xs, xg = xs.cpu().numpy(), xg.cpu().numpy()
    lz = torch.stack([lz_s, lz_g, lz_0]).double().cpu().numpy()
    return {i: (xs[j], float(lz[0, j]), xg[j], float(lz[1, j]), float(lz[2, j]))
            for j, i in enumerate(idx)}


def decide_sweep(cand, results, cfg: PipelineConfig, n_bands: int):
    """The host decisions of a sweep, as JAX makes them: prune on the
    evidence gain, p_star from the Laplace margin, galaxy only past the
    margin with an extended profile, then merge halo fragments into the
    brighter galaxies.  Updates ``cand`` in place."""
    for i, ci in enumerate(cand):
        if not ci["alive"]:
            continue
        xs, lz_s, xg, lz_g, lz_0 = results[i]
        if not cfg.classify:
            lz_g = -np.inf
        if max(lz_s, lz_g) < lz_0 + cfg.prune_min_evidence:
            ci["alive"] = False
            continue
        ci["p"] = _sigmoid(lz_s - lz_g) if cfg.classify else 1.0
        sigma_fit = float(np.exp(xg[3 + n_bands])) if cfg.classify else 0.0
        is_galaxy = (cfg.classify and lz_g > lz_s + cfg.galaxy_margin_nats
                     and sigma_fit > cfg.galaxy_sigma_min_arcsec)
        if is_galaxy:
            ci["kind"], ci["x"] = "galaxy", np.asarray(xg)
        else:
            ci["kind"], ci["x"] = "star", np.asarray(xs)
    # merge pass: a fitted galaxy owns its interior -- candidates whose
    # centres fall within merge_sigma_factor x sigma of a brighter galaxy
    # are halo fragments, not sources
    alive_now = [c for c in cand if c["alive"]]
    for g in sorted((c for c in alive_now if c["kind"] == "galaxy"),
                    key=lambda c: -float(np.exp(c["x"][2]))):
        if not g["alive"]:
            continue
        sig_g = float(np.exp(g["x"][3 + n_bands]))
        r_merge = cfg.merge_sigma_factor * np.clip(sig_g, 0.5, 4.0)
        flux_g = float(np.exp(g["x"][2]))
        for c in cand:
            if c is g or not c["alive"]:
                continue
            dist = float(np.hypot(c["x"][0] - g["x"][0], c["x"][1] - g["x"][1]))
            if dist < r_merge and float(np.exp(c["x"][2])) < flux_g:
                c["alive"] = False


def ambiguous_candidates(cand, results, cfg: PipelineConfig):
    """The alive candidates whose last sweep's |Laplace margin| lies inside
    ``galaxy_margin_nats``: where the margin rule is a coin toss and the
    type sampler decides."""
    return [i for i, c in enumerate(cand)
            if c["alive"] and abs(results[i][3] - results[i][1]) < cfg.galaxy_margin_nats]


def type_switch_stage(cond: Conditional, cand, amb_idx, cfg: PipelineConfig):
    """Stage 2b: the Carlin-Chib sampler on the ambiguous candidates'
    conditional posteriors, candidates x chains in one batch per block,
    candidate i drawing from the stream (seed, TYPE_SWITCH, i).  Returns
    (p_star, switch_rate, x_star_mean, x_gal_mean) as NumPy, one row per
    candidate of ``amb_idx``."""
    nb = cond.n_bands
    ds, dg = 2 + nb, 6 + nb
    rects = np.stack([_rect_of(c, ds, dg) for c in cand])
    folded = cond.fold(rects, [c["kind"] == "star" for c in cand], [c["alive"] for c in cand])
    x0 = torch.as_tensor(rects[amb_idx], device=cond.device)
    gens = [seeded_generator(cond.device, cfg.seed, TYPE_SWITCH, i) for i in amb_idx]
    out = sample_source_type_core(gens, cond.logdensity("star", amb_idx, folded),
                                  cond.logdensity("galaxy", amb_idx, folded), x0[:, :ds], x0,
                                  n_chains=cfg.type_switch_chains,
                                  n_steps=cfg.type_switch_steps, n_map_steps=cfg.map_steps)
    return tuple(out[k].cpu().numpy() for k in ("p_star", "switch_rate", "x_star_mean",
                                                "x_gal_mean"))


def sample_scene(logd, joint0, cfg: PipelineConfig, device):
    """Stage 3: the joint posterior from the classified MAPs ``joint0``
    [D], ``cfg.n_chains`` chains.  ChEES: a diagonal HMC warmup, a 16-step
    HMC probe at the adapted metric, the pooled ensemble covariance, ChEES
    warmup and run in the whitened space (the JAX pipeline's recipe).
    Returns (samples [C, n, D], summary of the last 3/4, divergence rate,
    acceptance rate or None for NUTS)."""
    gens = [seeded_generator(device, cfg.seed, JOINT, k) for k in range(5)]
    d_total = joint0.shape[0]
    x0b = (torch.as_tensor(joint0, device=device)[None, :]
           + 0.005 * torch.randn((cfg.n_chains, d_total), generator=gens[0], device=device))
    states, ss, im = hmc_warmup(gens[1], logd, x0b, n_warmup=cfg.n_warmup,
                                n_leapfrog=cfg.n_leapfrog)
    step_size, inv_mass = float(torch.quantile(ss, 0.5)), torch.mean(im, dim=0)
    if cfg.sampler == "chees":
        kern = hmc_kernel(logd, step_size, inv_mass, n_leapfrog=cfg.n_leapfrog)
        s_probe, _, _ = run_chains_ensemble(gens[2], kern, states, n_steps=16)
        m_hat, cov_hat = ensemble_covariance(s_probe, ridge=1e-4)
        logd_z, to_x, to_z = whiten_logdensity(logd, m_hat, cov_hat)
        st, eps, traj = chees_warmup(gens[3], logd_z, to_z(states.x), n_warmup=100,
                                     init_step_size=0.3, max_leapfrog=64)
        samples_z, _, info = run_chees_ensemble(gens[4], logd_z, st, n_steps=cfg.n_steps,
                                                step_size=float(eps),
                                                trajectory_length=float(traj),
                                                max_leapfrog=64)
        samples = to_x(samples_z)
        div, accept = float(torch.mean(info.divergence_rate)), float(torch.mean(info.accept_rate))
    else:
        kern = nuts_kernel(logd, step_size=step_size, inv_mass=inv_mass,
                           max_depth=cfg.max_depth)
        samples, _, info = run_chains_ensemble(gens[2], kern, states, n_steps=cfg.n_steps)
        div, accept = float(torch.mean(info.diverged.to(torch.float32))), None
    return samples, summarize(samples[:, cfg.n_steps // 4:]), div, accept


def run_pipeline(stamps, band=0, n_bands: int | None = None,
                 cfg: PipelineConfig = PipelineConfig(),
                 priors: Optional[SourcePriors] = None,
                 logger: Optional[MetricsLogger] = None,
                 detect_band_index: int = 0):
    """Pixels -> posterior catalog, on the stamps' device.

    ``stamps``: one Stamp or a list of per-band Stamps; ``band``: the flux
    slot per stamp (int for one stamp, list for several).  ``n_bands``
    defaults to the number of stamps.  ``detect_band_index`` selects which
    stamp drives detection (use the deepest band).  Returns (catalog, a
    dict of artifacts: samples, summary, scene, n_sources and, with
    ``cfg.ppc``, the check per band)."""
    if not isinstance(stamps, (list, tuple)):
        stamps = [stamps]
    stamps = list(stamps)
    bands = list(band) if isinstance(band, (list, tuple)) else [band] * len(stamps)
    n_bands = n_bands if n_bands is not None else max(len(stamps), max(bands) + 1)
    logger = logger or MetricsLogger()
    priors = priors or SourcePriors()
    cond = Conditional(stamps, bands, n_bands, priors)

    with torch.no_grad():
        # -- 1. iterative detect -> star MAP -> subtract (CLEAN-style) -----
        star_maps, snr_log = detect(cond, cfg, detect_band_index)
        logger.log("detect", n_candidates=len(star_maps), snrs=np.round(snr_log, 1).tolist())
        if not star_maps:
            return [], {"n_sources": 0}

        # -- 2. conditional classification sweeps + merging + pruning ------
        cand = [{"kind": "star", "x": np.asarray(m), "p": 1.0, "alive": True}
                for m in star_maps]
        results = {}
        for sweep in range(cfg.classify_sweeps):
            results = classify_sweep(cond, cand, cfg)
            decide_sweep(cand, results, cfg, n_bands)
            logger.log("classify_sweep", sweep=sweep,
                       kinds=[c["kind"] for c in cand if c["alive"]],
                       p_star=[round(c["p"], 3) for c in cand if c["alive"]],
                       pruned=sum(not c["alive"] for c in cand),
                       candidates=list(results),
                       lz_star=[r[1] for r in results.values()],
                       lz_galaxy=[r[3] for r in results.values()],
                       lz_none=[r[4] for r in results.values()])

    return sample_catalog(cond, cand, results, cfg, logger)


def sample_catalog(cond: Conditional, cand, results, cfg: PipelineConfig,
                   logger: Optional[MetricsLogger] = None):
    """Stages 2b-5 from the candidates ``cand`` and the ``results`` of the
    last classify sweep (``run_pipeline``'s state after its sweeps): the
    type switch on the ambiguous ones, joint sampling, the catalog and, with
    ``cfg.ppc``, the check.  Updates ``cand`` in place; returns what
    ``run_pipeline`` does."""
    stamps, bands, n_bands, device = cond.stamps, cond.bands, cond.n_bands, cond.device
    logger = logger or MetricsLogger()
    with torch.no_grad():
        # -- 2b. exact type decision for the ambiguous band ----------------
        if cfg.classify and cfg.type_switch and cfg.classify_sweeps > 0:
            amb_idx = ambiguous_candidates(cand, results, cfg)
            if amb_idx:
                p_star_b, sw_b, xs_mean, xg_mean = type_switch_stage(cond, cand, amb_idx, cfg)
                for j, i in enumerate(amb_idx):
                    ci = cand[i]
                    ci["p"] = float(p_star_b[j])
                    # the sampler's P(star) replaces the sigmoid of the
                    # Laplace margin, but the extendedness guard stays: a
                    # "galaxy" whose posterior sigma is far below the PSF
                    # is a point source absorbing blend residuals
                    sigma_mean = float(np.exp(xg_mean[j][3 + n_bands]))
                    if ci["p"] < 0.5 and sigma_mean > cfg.galaxy_sigma_min_arcsec:
                        ci["kind"], ci["x"] = "galaxy", np.asarray(xg_mean[j])
                    else:
                        ci["kind"], ci["x"] = "star", np.asarray(xs_mean[j])
                logger.log("type_switch", candidates=amb_idx,
                           p_star=np.round(p_star_b, 3).tolist(),
                           switch_rate=np.round(sw_b, 3).tolist(),
                           sigma_mean=[round(float(np.exp(x[3 + n_bands])), 3)
                                       for x in xg_mean],
                           kinds=[cand[i]["kind"] for i in amb_idx])

        alive = [c for c in cand if c["alive"]]
        if not alive:
            return [], {"n_sources": 0}
        kinds = [c["kind"] for c in alive]
        p_stars = [c["p"] for c in alive]
        n_src = len(alive)

        # -- 3. joint sampling ---------------------------------------------
        scene = CrowdedScene(kinds=tuple(kinds), n_bands=n_bands)
        logd = make_crowded_logdensity(scene, stamps, bands=bands, priors=cond.priors)
        blocks, d_total = scene.block_slices()
        joint0 = np.zeros(d_total, np.float32)
        for (off, d, _), c in zip(blocks, alive):
            joint0[off:off + d] = c["x"]
        samples, summ, div, accept = sample_scene(logd, joint0, cfg, device)
        kept = samples[:, cfg.n_steps // 4:]
        logger.log("sample", rhat_max=float(torch.max(summ["rhat"])),
                   ess_min=float(torch.min(summ["ess"])), divergence_frac=div,
                   accept_rate=accept)

    # -- 4. catalog ----------------------------------------------------------
    kept = kept.cpu().numpy()
    flat = kept.reshape(-1, d_total)
    catalog: List[CatalogEntry] = []
    for (off, d, kind), p_star in zip(blocks, p_stars):
        block = flat[:, off:off + d]
        du = block[:, :2]
        flux = np.exp(block[:, 2:2 + n_bands])
        extras = {}
        if kind == "galaxy":
            theta = 1 / (1 + np.exp(-block[:, 2 + n_bands]))
            sigma = np.exp(block[:, 3 + n_bands])
            ab = 1 / (1 + np.exp(-block[:, 4 + n_bands]))
            extras = {
                "theta_dev_mean": float(theta.mean()), "sigma_mean": float(sigma.mean()),
                "sigma_std": float(sigma.std()), "ab_mean": float(ab.mean()),
                "phi_mean": float(block[:, 5 + n_bands].mean()),
            }
        catalog.append(CatalogEntry(
            kind=kind, p_star=p_star,
            du_mean=du.mean(0), du_std=du.std(0),
            flux_mean=flux.mean(0), flux_std=flux.std(0),
            extras=extras,
        ))
    artifacts = {"samples": samples.cpu().numpy(), "summary": summ, "scene": scene,
                 "n_sources": n_src}

    # -- 5. posterior-predictive check (optional) ------------------------------
    # replicate counts from posterior draws (K7 renders them) and score the
    # observed deviance against the replicate distribution per band
    if cfg.ppc:
        from celeste_tpu_torch.ppc import ppc_chi2_pvalue, ppc_lambda_draws, ppc_pixel_zscores

        ppc_out = []
        for st, b in zip(stamps, bands):
            lam = ppc_lambda_draws(scene, kept, st, band=b, n_draws=cfg.ppc_draws,
                                   seed=cfg.seed)
            counts = st.counts.cpu().numpy()
            mask = st.mask.cpu().numpy().astype(bool)
            pv, _, _ = ppc_chi2_pvalue(lam, counts, mask=mask, seed=cfg.seed)
            z = ppc_pixel_zscores(lam, counts)
            worst = float(np.max(np.abs(np.where(mask, z, 0.0))))
            ppc_out.append({"band": int(b), "pvalue": pv, "worst_pixel_z": worst})
            logger.log("ppc", band=int(b), pvalue=pv, worst_pixel_z=worst)
        artifacts["ppc"] = ppc_out
    return catalog, artifacts
