"""Field-scale catalog pipeline: full survey frames -> posterior catalogs
(counterpart of ``celeste_tpu/field.py``).

The stamp pipeline (``pipeline.py``) fits every candidate on the whole
image and samples the scene jointly; on a frame that is quadratic waste.
Here the framework cuts, groups and scales:

  1. detect   -- bulk matched-filter peaks + batched cutout star MAPs, a few
                 CLEAN rounds (subtract every fit, re-detect on the
                 residual); cost O(N_src CUT^2) per round.
  2. group    -- union-find on detections: sources closer than
                 ``link_radius_px`` are sampled jointly.
  3. classify -- the stamp pipeline's Jacobi conditional sweeps (star,
                 galaxy or absent by Laplace evidence, merge, prune, dedup)
                 on per-candidate cutouts with leave-one-out effective
                 skies; ambiguous candidates get the Carlin-Chib type
                 sampler (``inference.type_switch``).
  4. sample   -- every fit group in one batch: groups padded to a
                 rectangular [G, S_max, 6 + B] state with star/alive flags
                 as data (``mixed_field_planes``), each group on its own
                 pixel set (nearest-candidate ownership, so no pixel counts
                 twice), neighbour groups' MAP lambdas folded into the
                 effective sky, and whitened ChEES (per-group dense metric,
                 per-group (eps, T)) over groups x chains
                 (``inference.chees`` with ``Groups``).
  5. catalog  -- per-source posterior summaries, global arcsec offsets.

The device work runs in the stamp kernels' pixel-set mode
(``kernels/mog_field.py``): each cutout or group is a pixel set of its own,
and one launch of K1 (likelihood and gradient) or K7 (render) per frame
serves a whole stage, its rows set-major.  The row order per call site:

  detection MAPs          one row per candidate, R = 1 row per set;
  classify sweep          candidate j's star row 2 j and galaxy row 2 j + 1
                          (``mixed_field_planes``), R = 2; its Laplace
                          Hessian all 2 (2 D + 1) points of candidate j;
  cutout lambdas (K7)     one row per candidate, R = 1;
  type switch             candidate i's chains (and its MAP and Hessian
                          rows), R = n_chains (8);
  group sampling          group g's chains, R = n_chains (32 for ``field``),
                          centered likelihood.

A group row carries S_max galaxy-wide slots of 48 components (a star's
inert past 3): a cluster linked into one group of 20 sources is 960
components a row.  On the card K1 stages a row's components in shared
memory whole where they fit (about 800 a row forward and 400 for K1-bwd
at 8 chains a block) and 96 at a time past that, with the same bits, so
any group runs, as on JAX's plain path.  The configs here have S_max 2-3.

The effective skies and the bookkeeping (ownership, origins, canvases) are
JAX's, in float64 NumPy on the host.  Pixel coordinates stay global: a
cutout is a gathered subset of the frame's pixel grid, so the frame's one
WCS affine serves every stage.

Random streams (``utils.rng`` paths under ``cfg.seed``): the type switch's
candidate i draws from (TYPE_SWITCH, i); fit group g's start jitter from
(FIELD, g) and each warmup window or sampling segment s of its phase k
from (FIELD, g, k, s).  A group's draws depend neither on the batch of
groups nor on the rank that holds it, and a run resumed from a checkpoint
draws what the unbroken run draws.  Segments are checkpoint boundaries
only: a segmented run and an unsegmented one draw from different streams
and agree in distribution.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from celeste_tpu_torch.inference.chees import (
    ChEESAdaptState,
    ChEESInfo,
    ChEESState,
    Groups,
    chees_warmup_finish,
    chees_warmup_init,
    chees_warmup_window,
    run_chees_ensemble,
)
from celeste_tpu_torch.inference.diagnostics import summarize
from celeste_tpu_torch.inference.map_fit import detect_peaks, map_fit
from celeste_tpu_torch.inference.model_select import hessian_fd, laplace_from_hessian
from celeste_tpu_torch.inference.whiten import ensemble_covariance, whiten_logdensity
from celeste_tpu_torch.kernels.mog_field import (
    _field_planes,
    mixed_field_planes,
    mog_field_loglik,
    mog_field_render,
    pad_pixel_sets,
)
from celeste_tpu_torch.model.priors import SourcePriors
from celeste_tpu_torch.mog import eval_grid
from celeste_tpu_torch.pipeline import CatalogEntry, _sigmoid, kind_logprior
from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from celeste_tpu_torch.utils.metrics import MetricsLogger
from celeste_tpu_torch.utils.rng import seeded_generator

FIELD, TYPE_SWITCH = 5, 77
GAL_SHAPE_INIT = np.array([0.0, 0.0, 0.0, 0.5], np.float32)


def STAR_D(b):
    return 2 + b


def GAL_D(b):
    return 6 + b


@dataclass
class FieldConfig:
    """Knobs for the field pipeline.  Defaults sized for SDSS-like frames
    (0.396''/px, ~1.4'' PSF FWHM)."""

    # -- detection ---------------------------------------------------------
    cut: int = 24                      # candidate cutout side (px)
    detect_band_index: int = 0         # which frame drives peak finding
    detection_snr_min: float = 5.0
    detection_min_separation: int = 5
    detection_rounds: int = 3          # CLEAN rounds (detect-fit-subtract)
    max_per_round: int = 64            # matched-filter peaks per round
    max_candidates: int = 256
    # -- grouping ----------------------------------------------------------
    link_radius_px: float = 12.0       # sources closer than this share a group
    group_margin_px: int = 12          # group cutout margin around the bbox
    group_cut: int = 48                # minimum group cutout side (px)
    # -- classification (same semantics as pipeline.PipelineConfig) --------
    classify: bool = True
    # max sweeps; the loop stops early once kinds/alive are stable.  The
    # serialized pruning retires at most one duplicate per neighborhood per
    # sweep, so the bound is the worst blend multiplicity, not 2.
    classify_sweeps: int = 5
    prune_min_evidence: float = 5.0
    # two candidates whose FITTED centers land within this of each other are
    # one source: under Jacobi conditional refits a duplicate pair settles
    # into a stable 50/50 flux split where both keep large leave-one-out
    # evidence; position proximity removes that fixed point.  Default ~= the
    # PSF FWHM: closer pairs are unresolvable point sources anyway.
    dedup_radius_arcsec: float = 1.2
    galaxy_margin_nats: float = 10.0
    galaxy_sigma_min_arcsec: float = 0.4
    merge_sigma_factor: float = 1.5
    type_switch: bool = True
    type_switch_chains: int = 8
    type_switch_steps: int = 300
    map_steps: int = 200
    # -- group sampling ----------------------------------------------------
    sample: bool = True                # False -> MAP-only catalog (fast scan)
    n_chains: int = 32
    probe_warmup: int = 80             # raw-space ChEES warmup iters
    probe_steps: int = 48              # raw-space probe draws (pool the metric)
    n_warmup: int = 100                # whitened-space ChEES warmup iters
    n_steps: int = 300
    max_leapfrog: int = 64
    init_step_size: float = 0.02
    init_jitter: float = 0.01
    # -- segmented execution -------------------------------------------------
    # Steps per sampling segment (None = one segment per phase) and warmup
    # iterations per window (default: the segment).  Segments are the
    # checkpoint's boundaries: with ``checkpoint_path`` the sampling stage's
    # carry is saved atomically after every window and segment, and a rerun
    # with the same path resumes where it stopped (detection and
    # classification recompute: they are deterministic), bitwise the
    # unbroken segmented run.
    sample_segment: Optional[int] = None
    warmup_window: Optional[int] = None
    checkpoint_path: Optional[str] = None
    seed: int = 0


# ---------------------------------------------------------------------------
# cutout gathering (host; pixel coordinates stay global)
# ---------------------------------------------------------------------------

def _cut_origin(cx, cy, cut, h, w):
    """Integer cutout origin, clipped so the window stays inside the frame."""
    ox = int(np.clip(round(cx - cut / 2), 0, max(w - cut, 0)))
    oy = int(np.clip(round(cy - cut / 2), 0, max(h - cut, 0)))
    return ox, oy


def _gather_cutouts(origins, cut, counts, sky, mask, device="cpu"):
    """origins [N, 2] int (ox, oy) -> per-candidate [N, cut*cut] float32
    tensors on ``device`` (px, py, counts, sky, mask), px/py in GLOBAL frame
    coordinates."""
    origins = np.asarray(origins, np.int64).reshape(-1, 2)
    n = origins.shape[0]
    dx = np.arange(cut)
    xs = origins[:, 0][:, None, None] + dx[None, None, :]      # [N, 1, cut]
    ys = origins[:, 1][:, None, None] + dx[None, :, None]      # [N, cut, 1]
    px = np.broadcast_to(xs, (n, cut, cut)).reshape(n, -1).astype(np.float32)
    py = np.broadcast_to(ys, (n, cut, cut)).reshape(n, -1).astype(np.float32)
    iy = np.broadcast_to(ys, (n, cut, cut))
    ix = np.broadcast_to(xs, (n, cut, cut))
    cts = counts[iy, ix].reshape(n, -1).astype(np.float32)
    sk = sky[iy, ix].reshape(n, -1).astype(np.float32)
    mk = mask[iy, ix].reshape(n, -1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (px, py, cts, sk, mk))


# ---------------------------------------------------------------------------
# fit groups
# ---------------------------------------------------------------------------

def union_groups(positions_px, link_radius_px: float):
    """Connected components of the overlap graph: i ~ j when their pixel
    positions are within ``link_radius_px``.  Returns int labels [N]
    (0..n_groups-1, ordered by first member).  Host NumPy union-find over
    a grid hash: candidates bucket into cells of side ``link_radius_px``,
    so only same-cell and forward-neighbour-cell pairs are distance-tested
    (near-linear in N), with the labels of the all-pairs graph."""
    pos = np.asarray(positions_px, np.float64).reshape(-1, 2)
    n = pos.shape[0]
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    r = float(link_radius_px)
    r2 = r * r
    cell = max(r, 1e-9)      # r<=0 still links coincident points
    keys = np.floor(pos / cell).astype(np.int64)
    buckets: dict = {}
    for i, kxy in enumerate(map(tuple, keys)):
        buckets.setdefault(kxy, []).append(i)
    # forward half-neighborhood covers each cell pair exactly once;
    # (0, 0) restricts to j > i within the cell
    offsets = ((0, 0), (1, 0), (0, 1), (1, 1), (1, -1))
    for (kx, ky), members in buckets.items():
        for dx, dy in offsets:
            other = members if dx == 0 and dy == 0 else buckets.get(
                (kx + dx, ky + dy))
            if not other:
                continue
            for i in members:
                pi = pos[i]
                for j in other:
                    if (dx or dy or j > i) and (
                            (pi[0] - pos[j][0]) ** 2
                            + (pi[1] - pos[j][1]) ** 2 <= r2):
                        ri, rj = find(i), find(j)
                        if ri != rj:
                            parent[max(ri, rj)] = min(ri, rj)
    roots = [find(i) for i in range(n)]
    order: dict = {}
    return np.asarray([order.setdefault(r_, len(order)) for r_ in roots],
                      np.int32)


# ---------------------------------------------------------------------------
# the rectangular prior with the kind and liveness as data
# ---------------------------------------------------------------------------

def _mixed_rect_logprior(rect, flags, alive, priors: SourcePriors, n_bands: int):
    """Prior + log|det J| of a rectangular [..., S, 6 + B] state whose
    star/galaxy kind is a flag per row ([..., S] bools, as data); dead rows
    (alive false: group padding) get a standard-normal anchor on every slot
    so the joint stays proper.  Both branches are computed for every row;
    the galaxy branch clamps the shape slots as ``mixed_field_planes`` does,
    so a star row's free-floating padding cannot overflow exp() and poison
    the other branch's gradient through 0 * inf.  Returns [...]."""
    sd, gd = STAR_D(n_bands), GAL_D(n_bands)
    head = rect[..., :sd]
    lp_star = (kind_logprior(priors, n_bands, "star", head)
               - 0.5 * torch.sum(rect[..., sd:gd] ** 2, dim=-1))
    v_gal = torch.cat([head, torch.clamp(rect[..., sd:gd], -12.0, 12.0)], dim=-1)
    lp_gal = kind_logprior(priors, n_bands, "galaxy", v_gal)
    lp_row = torch.where(flags, lp_star, lp_gal)
    anchor = -0.5 * torch.sum(rect * rect, dim=-1)
    return torch.sum(torch.where(alive, lp_row, anchor), dim=-1)


# ---------------------------------------------------------------------------
# sampling-stage checkpoint
# ---------------------------------------------------------------------------

def _fp_equal(a: dict, b: dict) -> bool:
    """Fingerprint-dict equality with float tolerance (values round-trip
    through JSON; 1e-6 relative covers repr noise, not real changes)."""
    if set(a) != set(b):
        return False
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, float) or isinstance(vb, float):
            if abs(float(va) - float(vb)) > 1e-6 * max(1.0, abs(float(vb))):
                return False
        elif va != vb:
            return False
    return True


class _SegCkpt:
    """Phase-aware checkpoint of the group sampler: one file, overwritten
    atomically at every window and segment boundary, holding the phase
    name, the offset within the phase and the phase's carry
    (``utils.checkpoint`` checks its structure, shapes and dtypes on load);
    a fingerprint of the initial chain states and of the stream-affecting
    knobs rejects a file of another run.  Each phase's carry holds what the
    later phases need, so a resume skips the phases done.  ``path=None``
    makes every method a no-op."""

    ORDER = ("raw_warmup", "probe", "z_warmup", "run")

    def __init__(self, path: Optional[str], fingerprint: dict):
        self.path, self.fp = path, dict(fingerprint)
        self.phase: Optional[str] = None
        self.off = 0
        if path and os.path.exists(path):
            with np.load(path, allow_pickle=False) as data:
                meta = json.loads(str(data["__meta__"]))
            ex = meta.get("extra", {})
            fp = ex.get("fp")
            # a file missing the fingerprint or the phase was written by
            # another producer sharing the path: foreign, as a mismatch is
            if (not isinstance(fp, dict) or "phase" not in ex
                    or not _fp_equal(fp, self.fp)):
                raise ValueError(
                    f"field checkpoint {path} belongs to a different run "
                    f"(fingerprint {fp!r} != {self.fp!r}): same path, "
                    "different frame/seed/config/priors — delete it or "
                    "point cfg.checkpoint_path elsewhere")
            self.phase, self.off = ex["phase"], int(meta["step"])

    def past(self, phase: str) -> bool:
        return (self.phase is not None
                and self.ORDER.index(self.phase) > self.ORDER.index(phase))

    def at(self, phase: str) -> bool:
        return self.phase == phase

    def load(self, like):
        state, step, _ = load_checkpoint(self.path, like)
        return state, int(step)

    def save(self, phase: str, carry, off: int) -> None:
        if not self.path:
            return
        save_checkpoint(self.path, carry, step=off, extra={"phase": phase, "fp": self.fp})
        self.phase, self.off = phase, off


# ---------------------------------------------------------------------------
# the frames' likelihoods on pixel sets
# ---------------------------------------------------------------------------

class _Frames:
    """The frames of a field and their batched log densities on pixel sets:
    ``sets`` holds one [S, PIX_PAD] pixel-set tuple per frame
    (``pad_pixel_sets``), and the rows of a call go set-major, R = rows / S
    per set (module docstring)."""

    def __init__(self, frames, bands, n_bands: int, priors: SourcePriors):
        self.frames, self.bands, self.nb, self.priors = frames, bands, n_bands, priors
        self.device = frames[0].device

    def planes(self, x, f, kind, flags=None):
        st, b = self.frames[f], self.bands[f]
        if kind == "mixed":
            return mixed_field_planes(x, st, b, self.nb, flags)
        return _field_planes(x, st, b, kind, self.nb)

    def logdensity(self, kind: str, sets, is_star=None):
        """The conditional log density ``[R_total, D] -> [R_total]`` of
        candidates on their cutouts: K1 on every frame's pixel sets plus the
        prior.  ``kind`` "star", "galaxy" or "mixed" (the rectangular
        layout; ``is_star`` one flag per problem, the problems splitting the
        rows evenly and the sets splitting the problems)."""
        flags = (torch.as_tensor(np.asarray(is_star, bool), device=self.device)
                 if kind == "mixed" else None)

        def logd(x):
            rows_flags = (flags.repeat_interleave(x.shape[0] // flags.shape[0])
                          if flags is not None else None)
            ll = 0.0
            for f, pd in enumerate(sets):
                ll = ll + mog_field_loglik(*self.planes(x, f, kind, rows_flags), pd)
            return ll + kind_logprior(self.priors, self.nb, kind, x, rows_flags)

        return logd

    def render(self, planes, pd, n_pix: int):
        """Sky-free lambda [N, n_pix] of one row per set (K7 with a zero
        sky), the padding cut off."""
        px, py, _, sky, _ = pd
        lam = mog_field_render(*planes, (px, py, None, torch.zeros_like(sky), None))
        return lam[:, :n_pix]


# ---------------------------------------------------------------------------
# the group sampler
# ---------------------------------------------------------------------------

def _windows(off0, total, width):
    """(offset, length) of the windows from ``off0`` of a phase of ``total``
    steps in windows of ``width`` (None: one window)."""
    w = width or max(total, 1)
    return [(off, min(w, total - off)) for off in range(off0, total, w)]


def _sample_groups(cfg: FieldConfig, logd, x0b, gids, ck: _SegCkpt, logger):
    """Raw-space ChEES warmup -> probe -> per-group dense metric ->
    whitened ChEES warmup -> run, over the groups ``gids`` (global group
    indices, for their streams) stacked set-major in ``x0b`` [G B, D], in
    windows and segments with a checkpoint at each boundary.  Returns
    (samples [G B, n_steps, D], ChEESInfo of [G, n_steps] fields)."""
    device = x0b.device
    n_g, nb = len(gids), cfg.n_chains
    d = x0b.shape[1]
    seg, wwin = cfg.sample_segment, cfg.warmup_window or cfg.sample_segment
    mlf = cfg.max_leapfrog

    def streams(phase, off, width):
        """The groups' streams for the window or segment at ``off``."""
        return Groups([seeded_generator(device, cfg.seed, FIELD, g, phase,
                                        0 if width is None else off // width) for g in gids], nb)

    def z_state():
        return ChEESState(xs=torch.zeros(n_g * nb, d, device=device),
                          logps=torch.zeros(n_g * nb, device=device),
                          grads=torch.zeros(n_g * nb, d, device=device))

    def z_adapt():
        return ChEESAdaptState(*(torch.zeros(n_g) for _ in range(8)))

    def z_info(n):
        return ChEESInfo(accept_rate=torch.zeros(n_g, n, device=device),
                         n_leapfrog=torch.zeros(n_g, n, dtype=torch.int32, device=device),
                         trajectory_length=torch.zeros(n_g, n, device=device),
                         step_size=torch.zeros(n_g, n, device=device),
                         divergence_rate=torch.zeros(n_g, n, device=device))

    def z_moments():
        return torch.zeros(n_g, d, device=device), torch.zeros(n_g, d, d, device=device)

    # ---- phase 1: raw-space warmup windows ---------------------------------
    pcarry = None
    if not ck.past("raw_warmup"):
        if ck.at("raw_warmup"):
            carry, off0 = ck.load((z_state(), z_adapt()))
        else:
            carry = chees_warmup_init(x0b, logd, init_step_size=cfg.init_step_size,
                                      groups=streams(0, 0, wwin))
            off0 = 0
        for off, w in _windows(off0, cfg.probe_warmup, wwin):
            carry = chees_warmup_window(None, logd, carry, w, init_step_size=cfg.init_step_size,
                                        max_leapfrog=mlf, groups=streams(0, off, wwin))
            ck.save("raw_warmup", carry, off + w)
        st1, eps1, traj1 = chees_warmup_finish(carry)
        pcarry = (st1, eps1, traj1, torch.zeros(n_g * nb, cfg.probe_steps, d, device=device))
        ck.save("probe", pcarry, 0)

    # ---- phase 2: raw-space probe segments (pool the dense metric) ---------
    zc = None
    if not ck.past("probe"):
        if pcarry is None:
            pcarry, poff = ck.load((z_state(), torch.zeros(n_g), torch.zeros(n_g),
                                    torch.zeros(n_g * nb, cfg.probe_steps, d, device=device)))
        else:
            poff = 0
        st, eps1, traj1, probe_buf = pcarry
        for off, w in _windows(poff, cfg.probe_steps, seg):
            p, st, _ = run_chees_ensemble(None, logd, st, w, eps1, traj1, max_leapfrog=mlf,
                                          start_iter=off, groups=streams(1, off, seg))
            probe_buf[:, off:off + w] = p
            ck.save("probe", (st, eps1, traj1, probe_buf), off + w)
        m_h, c_h = ensemble_covariance(probe_buf[:, ::2], ridge=1e-4, groups=n_g)
        logd_z, _, to_z = whiten_logdensity(logd, m_h, c_h)
        zc = (m_h, c_h, chees_warmup_init(to_z(st.xs), logd_z, init_step_size=0.3,
                                          groups=streams(2, 0, wwin)))
        ck.save("z_warmup", zc, 0)

    # ---- phase 3: whitened-space warmup windows ----------------------------
    rcarry = None
    if not ck.past("z_warmup"):
        if zc is None:
            zc, zoff = ck.load((*z_moments(), (z_state(), z_adapt())))
        else:
            zoff = 0
        m_h, c_h, zcarry = zc
        logd_z, _, _ = whiten_logdensity(logd, m_h, c_h)
        for off, w in _windows(zoff, cfg.n_warmup, wwin):
            zcarry = chees_warmup_window(None, logd_z, zcarry, w, init_step_size=0.3,
                                         max_leapfrog=mlf, groups=streams(2, off, wwin))
            ck.save("z_warmup", (m_h, c_h, zcarry), off + w)
        st2, eps2, traj2 = chees_warmup_finish(zcarry)
        rcarry = (st2, eps2, traj2, m_h, c_h,
                  torch.zeros(n_g * nb, cfg.n_steps, d, device=device), z_info(cfg.n_steps))
        ck.save("run", rcarry, 0)

    # ---- phase 4: frozen-(eps, T) sampling segments ------------------------
    if rcarry is None:
        rcarry, roff = ck.load((z_state(), torch.zeros(n_g), torch.zeros(n_g), *z_moments(),
                                torch.zeros(n_g * nb, cfg.n_steps, d, device=device),
                                z_info(cfg.n_steps)))
    else:
        roff = 0
    stz, eps2, traj2, m_h, c_h, samples_buf, info_buf = rcarry
    logd_z, to_x, _ = whiten_logdensity(logd, m_h, c_h)
    for off, w in _windows(roff, cfg.n_steps, seg):
        sz, stz, info = run_chees_ensemble(None, logd_z, stz, w, eps2, traj2, max_leapfrog=mlf,
                                           start_iter=off, groups=streams(3, off, seg))
        samples_buf[:, off:off + w] = to_x(sz)
        for buf, leaf in zip(info_buf, info):
            buf[:, off:off + w] = leaf
        ck.save("run", (stz, eps2, traj2, m_h, c_h, samples_buf, info_buf), off + w)
        logger.log("field_sample_segment", done=off + w, total=cfg.n_steps)
    return samples_buf, info_buf


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _check_cfg(cfg: FieldConfig):
    # 0 would make a zero-width window; negatives would mis-slice: fail
    # before any detection work
    if cfg.sample_segment is not None and cfg.sample_segment < 1:
        raise ValueError(f"cfg.sample_segment must be >= 1 (got {cfg.sample_segment}); "
                         "use None for one segment per phase")
    if cfg.warmup_window is not None and cfg.warmup_window < 1:
        raise ValueError(f"cfg.warmup_window must be >= 1 (got {cfg.warmup_window}); "
                         "use None to default to sample_segment")
    if cfg.checkpoint_path and cfg.sample_segment is None:
        raise ValueError("cfg.checkpoint_path requires cfg.sample_segment: "
                         "the segments are the checkpoint's boundaries")


def run_field_pipeline(stamp, band=0, n_bands: Optional[int] = None,
                       cfg: FieldConfig = FieldConfig(),
                       priors: Optional[SourcePriors] = None,
                       logger: Optional[MetricsLogger] = None,
                       mesh=None):
    """Frame pixels -> posterior catalog at field scale, on the frames'
    device.

    ``stamp``: one frame ``Stamp`` or a list of per-band frames (each with
    its own WCS, PSF and calibration; frames need not be pixel-registered);
    ``band``: the flux slot per frame (int, or a list matching ``stamp``);
    ``n_bands`` defaults to the number of frames.  With several frames the
    likelihood is the joint product over bands at every stage; peaks are
    found on ``cfg.detect_band_index``'s frame, and the grouping and pixel
    ownership live in that frame's pixel grid.

    ``mesh``: a ``parallel.mesh`` mesh with a ``groups`` dimension.  Fit
    groups share no pixels, so they are data parallel: the groups are
    padded to a multiple of the ranks with dead groups (mask 0, alive 0,
    effective sky 1, counts 0: likelihood exactly 0, the state samples the
    standard-normal anchor), each rank samples its contiguous groups, and
    the samples are gathered by one all-reduce of a zero-padded buffer.  A
    group draws from its own streams, so the result is the single-device
    run's.

    Returns ``(catalog, artifacts)``: a list of ``pipeline.CatalogEntry``
    (``extras['group']`` the fit group) and the artifacts (groups, samples
    [G, B, n_steps, D_g], per-group diagnostics).
    """
    _check_cfg(cfg)
    priors = priors or SourcePriors()
    logger = logger or MetricsLogger()
    frames = list(stamp) if isinstance(stamp, (list, tuple)) else [stamp]
    bands = list(band) if isinstance(band, (list, tuple)) else [band] * len(frames)
    n_bands = n_bands if n_bands is not None else max(len(frames), max(bands) + 1)
    nf = len(frames)
    di = cfg.detect_band_index
    device = frames[0].device
    fr = _Frames(frames, bands, n_bands, priors)
    counts_l = [st.counts.cpu().numpy().astype(np.float64) for st in frames]
    sky_l = [st.sky.cpu().numpy().astype(np.float64) for st in frames]
    mask_l = [st.mask.cpu().numpy().astype(np.float64) for st in frames]
    hw_l = [c.shape for c in counts_l]
    cut = int(min([cfg.cut] + [min(s) for s in hw_l]))
    ds, gd = STAR_D(n_bands), GAL_D(n_bands)
    a_l = [st.wcs_A.cpu().numpy().astype(np.float64) for st in frames]
    a_inv_l = [np.linalg.inv(a) for a in a_l]
    p0_l = [st.wcs_p0.cpu().numpy().astype(np.float64) for st in frames]
    zero = torch.zeros((), device=device)
    psf_peak = float(eval_grid(frames[di].psf, zero, zero))
    iota = float(frames[di].iota)

    def _frame_origins(du_list):
        """Candidate arcsec offsets -> per-frame integer cutout origins
        [nf][N, 2] (each frame's own WCS; windows clipped inside)."""
        outs = []
        for f in range(nf):
            h_f, w_f = hw_l[f]
            pos = np.asarray([p0_l[f] + a_l[f] @ np.asarray(du, np.float64) for du in du_list])
            outs.append(np.asarray([_cut_origin(cx, cy, cut, h_f, w_f) for cx, cy in pos]))
        return outs

    def _gather_all(origins_l, cut_, data_l):
        """Per-frame cutouts -> one [N, cut_^2] tuple (px, py, counts, sky,
        mask) per frame."""
        return [_gather_cutouts(origins_l[f], cut_, *data_l[f], device=device)
                for f in range(nf)]

    def _sets(cut_data, **replace):
        """Per frame, the cutouts as lane-padded pixel sets, with any of
        counts, sky, mask replaced by a [N, nf, P] tensor."""
        out = []
        for f, pd in enumerate(cut_data):
            px, py, cts, sk, mk = pd
            cts = replace["counts"][:, f] if "counts" in replace else cts
            sk = replace["sky"][:, f] if "sky" in replace else sk
            out.append(pad_pixel_sets(px, py, cts, sk, mk))
        return out

    with torch.no_grad():
        # ---- 1. detect: bulk matched filter + batched MAPs, CLEAN rounds ---
        work_l = [c.copy() for c in counts_l]
        det = frames[di]
        cand_pos: list = []          # detect-frame pixel (x, y)
        cand_x: list = []            # star MAP vectors [ds]
        snr_log: list = []
        for rnd in range(cfg.detection_rounds):
            det_stamp = SimpleNamespace(counts=work_l[di].astype(np.float32), sky=det.sky,
                                        psf=det.psf)
            peaks, snrs = detect_peaks(det_stamp, n_peaks=cfg.max_per_round,
                                       min_separation=cfg.detection_min_separation)
            sel = []
            for (pxk, pyk), s in zip(peaks, snrs):
                if s < cfg.detection_snr_min:
                    break
                if any(np.hypot(pxk - q[0], pyk - q[1]) < cfg.detection_min_separation
                       for q in cand_pos):
                    continue        # residual ripple of an already-fit source
                # same-round peaks must not share cutout pixels: two fits of
                # the same flux would each absorb it and the batch
                # subtraction would remove it twice; coupled peaks wait for
                # the next round, after the brighter one's fit is subtracted
                if any(np.hypot(pxk - t[0], pyk - t[1]) < cut for t in sel):
                    continue
                if len(cand_pos) + len(sel) >= cfg.max_candidates:
                    break
                sel.append((pxk, pyk, s))
            if not sel:
                break
            du_sel, x0s = [], []
            for px_, py_, _ in sel:
                du0 = a_inv_l[di] @ (np.array([px_, py_]) - p0_l[di])
                du_sel.append(du0)
                peak = max(float(work_l[di][int(py_), int(px_)]
                                 - sky_l[di][int(py_), int(px_)]), 1.0)
                x0s.append(np.concatenate(
                    [du0, np.full(n_bands, np.log(peak / (iota * psf_peak)))]))
            origins_l = _frame_origins(du_sel)
            cut_data = _gather_all(origins_l, cut, [(work_l[f], sky_l[f], mask_l[f])
                                                    for f in range(nf)])
            x_maps, lams = _det_fit_batch(fr, cfg, torch.as_tensor(
                np.stack(x0s), dtype=torch.float32, device=device), _sets(cut_data), cut * cut)
            for k in range(len(sel)):
                for f in range(nf):
                    ox, oy = origins_l[f][k]
                    work_l[f][oy:oy + cut, ox:ox + cut] -= lams[k, f].reshape(cut, cut)
                cand_pos.append((sel[k][0], sel[k][1]))
                cand_x.append(x_maps[k])
                snr_log.append(sel[k][2])
            logger.log("detect_round", round=rnd, found=len(sel), total=len(cand_pos))
        n_cand = len(cand_pos)
        logger.log("detect", n_candidates=n_cand, snrs=np.round(snr_log, 1).tolist())
        if n_cand == 0:
            return [], {"n_sources": 0, "n_groups": 0}

        # cutout origins tied to the FITTED positions (stable across sweeps)
        origins_l = _frame_origins([np.asarray(x[:2], np.float64) for x in cand_x])
        cut_data = _gather_all(origins_l, cut, [(counts_l[f], sky_l[f], mask_l[f])
                                                for f in range(nf)])
        render_sets = _sets(cut_data)

        # ---- 2+3. classify: Jacobi sweeps with leave-one-out effective skies
        cand = [{"kind": "star", "x": np.asarray(x, np.float32), "p": 1.0, "alive": True}
                for x in cand_x]

        def _rect_of(c):
            r = np.zeros(gd, np.float32)
            if c["kind"] == "star":
                r[:ds] = c["x"][:ds]
                r[ds:] = GAL_SHAPE_INIT
            else:
                r[:] = c["x"]
            return r

        def _cand_lams():
            """Every candidate's sky-free lambda on its cutouts from its
            current state, dead ones zeroed: [N, nf, P] float64 NumPy."""
            rects = torch.as_tensor(np.stack([_rect_of(c) for c in cand]), device=device)
            flags = torch.as_tensor([c["kind"] == "star" for c in cand], device=device)
            lams = np.stack([fr.render(fr.planes(rects, f, "mixed", flags), render_sets[f],
                                       cut * cut).cpu().numpy() for f in range(nf)],
                            axis=1).astype(np.float64)
            lams[~np.asarray([c["alive"] for c in cand])] = 0.0
            return lams

        def _scatter_total(lams_np, alive_np):
            """Scatter alive candidates' cutout lambdas ([N, nf, P]) into one
            canvas per frame."""
            canvas_l = [np.zeros(hw_l[f], np.float64) for f in range(nf)]
            for f in range(nf):
                for i, (ox, oy) in enumerate(origins_l[f]):
                    if alive_np[i]:
                        canvas_l[f][oy:oy + cut, ox:ox + cut] += lams_np[i, f].reshape(cut, cut)
            return canvas_l

        def _gather_eff(canvas_l, lams_np):
            """Per-candidate effective sky on its cutouts: sky + total - own,
            per frame -> [N, nf, P] float32 on the device."""
            eff = np.empty((n_cand, nf, cut * cut), np.float32)
            for f in range(nf):
                for i, (ox, oy) in enumerate(origins_l[f]):
                    tot = canvas_l[f][oy:oy + cut, ox:ox + cut].reshape(-1)
                    eff[i, f] = np.maximum(sky_l[f][oy:oy + cut, ox:ox + cut].reshape(-1)
                                           + tot - lams_np[i, f], 1e-6)
            return torch.as_tensor(eff, device=device)

        def _eff_now():
            lams_np = _cand_lams()
            alive_np = np.asarray([c["alive"] for c in cand])
            return _gather_eff(_scatter_total(lams_np, alive_np), lams_np)

        lz_s_b = lz_g_b = None
        state_prev = None
        cut_arcsec = cut * float(np.abs(a_inv_l[di]).max())  # cutout side, ''
        for sweep in range(cfg.classify_sweeps):
            rects = np.stack([_rect_of(c) for c in cand])
            eff = _eff_now()
            xs_b, lz_s_b, xg_b, lz_g_b, lz_0_b = _classify_batch(
                fr, cfg, torch.as_tensor(rects, device=device), _sets(cut_data, sky=eff), eff,
                cut_data)
            # pruning is neighbourhood-serialized: under Jacobi sweeps two
            # candidates splitting one source's flux each look redundant
            # given the other, and a naive threshold prunes both.  Per sweep,
            # prune the weakest candidate of each cutout-sized neighbourhood
            # only; its neighbours are re-judged next sweep.
            below = []
            for i, ci in enumerate(cand):
                if not ci["alive"]:
                    continue
                lz_s, lz_g = float(lz_s_b[i]), float(lz_g_b[i])
                if not cfg.classify:
                    lz_g = -np.inf
                gain = max(lz_s, lz_g) - float(lz_0_b[i])
                if gain < cfg.prune_min_evidence:
                    below.append((gain, i))
            pruned_now: list = []
            for _, i in sorted(below):
                xi = cand[i]["x"]
                if any(np.hypot(xi[0] - cand[j]["x"][0], xi[1] - cand[j]["x"][1]) < cut_arcsec
                       for j in pruned_now):
                    continue
                cand[i]["alive"] = False
                pruned_now.append(i)
            for i, ci in enumerate(cand):
                if not ci["alive"]:
                    continue
                lz_s, lz_g = float(lz_s_b[i]), float(lz_g_b[i])
                if not cfg.classify:
                    lz_g = -np.inf
                ci["p"] = _sigmoid(lz_s - lz_g) if cfg.classify else 1.0
                sigma_fit = float(np.exp(xg_b[i][3 + n_bands])) if cfg.classify else 0.0
                if (cfg.classify and lz_g > lz_s + cfg.galaxy_margin_nats
                        and sigma_fit > cfg.galaxy_sigma_min_arcsec):
                    ci["kind"], ci["x"] = "galaxy", np.asarray(xg_b[i])
                else:
                    ci["kind"], ci["x"] = "star", np.asarray(xs_b[i])
            # positional dedup (all kinds): refits move CLEAN-ripple
            # duplicates onto the source they re-detected; keep the
            # higher-evidence one
            gains = {i: max(float(lz_s_b[i]), float(lz_g_b[i]) if cfg.classify else -np.inf)
                     - float(lz_0_b[i]) for i in range(n_cand)}
            alive_now = [i for i, c in enumerate(cand) if c["alive"]]
            for a_ix, i in enumerate(alive_now):
                if not cand[i]["alive"]:
                    continue
                for j in alive_now[a_ix + 1:]:
                    if not cand[j]["alive"]:
                        continue
                    d = float(np.hypot(cand[i]["x"][0] - cand[j]["x"][0],
                                       cand[i]["x"][1] - cand[j]["x"][1]))
                    if d < cfg.dedup_radius_arcsec:
                        loser = i if gains[i] < gains[j] else j
                        cand[loser]["alive"] = False
            # merge: a fitted galaxy owns its interior (halo fragments are
            # not sources)
            for g in sorted((c for c in cand if c["alive"] and c["kind"] == "galaxy"),
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
            logger.log("classify_sweep", sweep=sweep,
                       kinds=[c["kind"] for c in cand if c["alive"]],
                       pruned=sum(not c["alive"] for c in cand),
                       du=[np.round(c["x"][:2], 2).tolist() for c in cand if c["alive"]],
                       gain=[round(gains[i], 1) for i, c in enumerate(cand) if c["alive"]],
                       lz_sg=[[round(float(lz_s_b[i]), 1), round(float(lz_g_b[i]), 1)]
                              for i, c in enumerate(cand) if c["alive"]])
            state_now = [(c["kind"], c["alive"]) for c in cand]
            if sweep > 0 and state_now == state_prev:
                break
            state_prev = state_now

        # exact Carlin-Chib decision for the ambiguous band (the stamp
        # pipeline's stage 2b)
        if cfg.classify and cfg.type_switch and cfg.classify_sweeps > 0:
            from celeste_tpu_torch.inference.type_switch import sample_source_type_core

            amb = [i for i, c in enumerate(cand)
                   if c["alive"] and abs(float(lz_g_b[i]) - float(lz_s_b[i]))
                   < cfg.galaxy_margin_nats]
            if amb:
                rects = torch.as_tensor(np.stack([_rect_of(c) for c in cand]), device=device)
                eff = _eff_now()
                idx = torch.as_tensor(amb, device=device)
                sets = _sets([tuple(t[idx] for t in pd) for pd in cut_data], sky=eff[idx])
                gens = [seeded_generator(device, cfg.seed, TYPE_SWITCH, i) for i in amb]
                out = sample_source_type_core(gens, fr.logdensity("star", sets),
                                              fr.logdensity("galaxy", sets), rects[idx, :ds],
                                              rects[idx], n_chains=cfg.type_switch_chains,
                                              n_steps=cfg.type_switch_steps,
                                              n_map_steps=cfg.map_steps)
                p_b, xs_m, xg_m = (out[k].cpu().numpy()
                                   for k in ("p_star", "x_star_mean", "x_gal_mean"))
                for j, i in enumerate(amb):
                    ps = float(p_b[j])
                    ci = cand[i]
                    ci["p"] = ps
                    sigma_mean = float(np.exp(xg_m[j][3 + n_bands]))
                    if ps < 0.5 and sigma_mean > cfg.galaxy_sigma_min_arcsec:
                        ci["kind"], ci["x"] = "galaxy", np.asarray(xg_m[j])
                    else:
                        ci["kind"], ci["x"] = "star", np.asarray(xs_m[j])
                logger.log("type_switch", candidates=amb, p_star=np.round(p_b, 3).tolist())

        alive_idx = [i for i, c in enumerate(cand) if c["alive"]]
        if not alive_idx:
            return [], {"n_sources": 0, "n_groups": 0}

        # ---- 4. group + sample: every group in one batch ---------------------
        # grouping and ownership live in the detect frame's pixel grid; each
        # frame also gets its own pixel positions for per-frame ownership
        alive_du = [np.asarray(cand[i]["x"][:2], np.float64) for i in alive_idx]
        alive_pos_l = [np.asarray([p0_l[f] + a_l[f] @ du for du in alive_du])
                       for f in range(nf)]
        alive_pos = alive_pos_l[di]
        labels = union_groups(alive_pos, cfg.link_radius_px)
        n_groups = int(labels.max()) + 1
        members = [[alive_idx[k] for k in np.nonzero(labels == g)[0]] for g in range(n_groups)]
        s_max = max(len(m) for m in members)
        logger.log("groups", n_groups=n_groups, s_max=s_max, sizes=[len(m) for m in members])

        if not cfg.sample:
            # MAP-only catalog: the detection and classification scan without
            # the posterior stage (stds are zero by construction)
            catalog: List[CatalogEntry] = []
            for g, mem in enumerate(members):
                for i in mem:
                    x, kind = cand[i]["x"], cand[i]["kind"]
                    catalog.append(CatalogEntry(
                        kind=kind, p_star=cand[i]["p"], du_mean=np.asarray(x[:2]),
                        du_std=np.zeros(2), flux_mean=np.exp(x[2:2 + n_bands]),
                        flux_std=np.zeros(n_bands), extras={"group": g}))
            return catalog, {"n_sources": len(catalog), "n_groups": n_groups,
                             "groups": members, "s_max": s_max}

        # group cutout side: every group's bbox + margin (one per run)
        need = cfg.group_cut
        for mem in members:
            pts = alive_pos[[alive_idx.index(i) for i in mem]]
            ext = float(max(np.ptp(pts[:, 0]), np.ptp(pts[:, 1])))
            need = max(need, int(np.ceil(ext)) + 2 * cfg.group_margin_px)
        gcut = int(min([-(-need // 8) * 8] + [min(s) for s in hw_l]))

        # final per-candidate lambdas for the neighbour groups' effective skies
        lams_f = _cand_lams()
        canvas_l = _scatter_total(lams_f, np.asarray([c["alive"] for c in cand]))

        group_du = [np.stack([alive_du[alive_idx.index(i)] for i in mem]).mean(axis=0)
                    for mem in members]
        g_orig_l = []
        for f in range(nf):
            h_f, w_f = hw_l[f]
            pos = [p0_l[f] + a_l[f] @ du for du in group_du]
            g_orig_l.append(np.asarray([_cut_origin(cx, cy, gcut, h_f, w_f) for cx, cy in pos]))
        per_f = [[t.cpu().numpy() for t in _gather_cutouts(g_orig_l[f], gcut, counts_l[f],
                                                           sky_l[f], mask_l[f])]
                 for f in range(nf)]
        # [G, nf, Pg] stacks (px, py, counts, sky, mask)
        g_px, g_py, g_cts, g_sky, g_mk = [np.stack([per_f[f][k] for f in range(nf)], axis=1)
                                          for k in range(5)]

        # pixel ownership: each frame pixel belongs to the group of its
        # nearest alive candidate (in that frame's pixel grid), so group
        # likelihoods never count a pixel twice in any band
        g_eff = np.empty_like(g_sky)
        for f in range(nf):
            ap = alive_pos_l[f]
            for g in range(n_groups):
                ox, oy = g_orig_l[f][g]
                pxg, pyg = g_px[g, f], g_py[g, f]
                d2 = ((pxg[None, :] - ap[:, 0][:, None]) ** 2
                      + (pyg[None, :] - ap[:, 1][:, None]) ** 2)
                owner = labels[np.argmin(d2, axis=0)]
                g_mk[g, f] = g_mk[g, f] * (owner == g)
                # neighbour groups' MAP lambdas -> effective sky on this cutout
                tot = canvas_l[f][oy:oy + gcut, ox:ox + gcut].reshape(-1)
                own = np.zeros(gcut * gcut, np.float64)
                for i in members[g]:
                    ox_i, oy_i = origins_l[f][i]
                    x0, y0 = max(ox_i, ox), max(oy_i, oy)
                    x1, y1 = min(ox_i + cut, ox + gcut), min(oy_i + cut, oy + gcut)
                    if x1 <= x0 or y1 <= y0:
                        continue
                    patch = lams_f[i, f].reshape(cut, cut)[y0 - oy_i:y1 - oy_i,
                                                           x0 - ox_i:x1 - ox_i]
                    own.reshape(gcut, gcut)[y0 - oy:y1 - oy, x0 - ox:x1 - ox] += patch
                g_eff[g, f] = np.maximum(g_sky[g, f] + np.maximum(tot - own, 0.0), 1e-6)

        # rectangular group states [G, S_max, GAL_D] + flags / alive as data
        rect_g = np.zeros((n_groups, s_max, gd), np.float32)
        flg_g = np.zeros((n_groups, s_max), bool)
        alv_g = np.zeros((n_groups, s_max), bool)
        for g, mem in enumerate(members):
            for k, i in enumerate(mem):
                rect_g[g, k] = _rect_of(cand[i])
                flg_g[g, k] = cand[i]["kind"] == "star"
                alv_g[g, k] = True
        d_g = s_max * gd
        n_ch = cfg.n_chains

        # dead padding groups for the mesh: mask 0 (likelihood exactly 0),
        # alive 0 (the standard-normal anchor), eff 1, counts 0, start at 0
        n_ranks, rank = _groups_axis(mesh)
        g_pad = (-n_groups) % n_ranks
        g_all = n_groups + g_pad
        per_rank = g_all // n_ranks
        gids = list(range(rank * per_rank, (rank + 1) * per_rank))

        def padded(a, fill):
            pad = np.full((g_pad,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad])[gids]

        x0 = np.concatenate([rect_g.reshape(n_groups, d_g), np.zeros((g_pad, d_g), np.float32)])
        starts = []
        for g in gids:
            x0_g = torch.as_tensor(x0[g], device=device).expand(n_ch, d_g)
            if g < n_groups:
                gen = seeded_generator(device, cfg.seed, FIELD, g)
                x0_g = x0_g + cfg.init_jitter * torch.randn((n_ch, d_g), generator=gen,
                                                            device=device)
            starts.append(x0_g)
        x0b = torch.cat(starts)
        flg = torch.as_tensor(padded(flg_g, False), device=device)
        alv = torch.as_tensor(padded(alv_g, False), device=device)
        g_sets = []
        for f in range(nf):
            px = np.concatenate([g_px[:, f], np.repeat(g_px[:1, f], g_pad, 0)])[gids]
            py = np.concatenate([g_py[:, f], np.repeat(g_py[:1, f], g_pad, 0)])[gids]
            g_sets.append(pad_pixel_sets(*(torch.as_tensor(a, device=device) for a in (
                px, py, padded(g_cts[:, f], 0.0), padded(g_eff[:, f], 1.0),
                padded(g_mk[:, f], 0.0)))))
        if mesh is not None:
            logger.log("shard_groups", n_ranks=n_ranks, n_groups=n_groups, padded_to=g_all)

        group_logd = _group_logdensity(fr, g_sets, flg, alv)
        ck_path = cfg.checkpoint_path
        if ck_path and n_ranks > 1:
            ck_path = f"{ck_path}.rank{rank}of{n_ranks}"
        ck = _SegCkpt(ck_path, fingerprint={
            # the initial chain states (frame + seed + grouping) ...
            "x0_sum": float(torch.sum(x0b.double())),
            # ... and every stream-affecting knob: a shape-preserving change
            # must fail the gate, not resume into a mixed-config run
            "probe_warmup": int(cfg.probe_warmup),
            "probe_steps": int(cfg.probe_steps),
            "n_warmup": int(cfg.n_warmup),
            "n_steps": int(cfg.n_steps),
            "max_leapfrog": int(cfg.max_leapfrog),
            "init_step_size": float(cfg.init_step_size),
            # prior hyperparameters enter the log density (the dataclass
            # repr is deterministic and covers every field)
            "priors": repr(priors),
        })
        samples, infos = _sample_groups(cfg, group_logd, x0b, gids, ck, logger)
        samples, infos = _gather_groups(mesh, samples, infos, rank * per_rank, g_all, n_ch)
        samples = samples.reshape(g_all, n_ch, cfg.n_steps, d_g)[:n_groups].cpu().numpy()
        infos = ChEESInfo(*(t[:n_groups].cpu().numpy() for t in infos))
    kept = samples[:, :, cfg.n_steps // 4:, :]

    # ---- 5. catalog ------------------------------------------------------------
    catalog = []
    diag = []
    for g, mem in enumerate(members):
        ks = kept[g]                                   # [B, T, D_g]
        cols = []
        for k_m, i in enumerate(mem):
            d = ds if cand[i]["kind"] == "star" else gd
            cols.extend(range(k_m * gd, k_m * gd + d))
        summ = summarize(torch.as_tensor(ks[..., cols]))
        diag.append({"group": g, "rhat_max": float(torch.max(summ["rhat"])),
                     "ess_min": float(torch.min(summ["ess"])),
                     "divergence_rate": float(np.mean(infos.divergence_rate[g])),
                     "accept_rate": float(np.mean(infos.accept_rate[g]))})
        flat = ks.reshape(-1, d_g)
        for k_m, i in enumerate(mem):
            blk = flat[:, k_m * gd:(k_m + 1) * gd]
            kind = cand[i]["kind"]
            du = blk[:, :2]
            flux = np.exp(blk[:, 2:2 + n_bands])
            extras = {"group": g}
            if kind == "galaxy":
                sigma = np.exp(blk[:, 3 + n_bands])
                extras.update({
                    "theta_dev_mean": float((1 / (1 + np.exp(-blk[:, 2 + n_bands]))).mean()),
                    "sigma_mean": float(sigma.mean()),
                    "sigma_std": float(sigma.std()),
                    "ab_mean": float((1 / (1 + np.exp(-blk[:, 4 + n_bands]))).mean()),
                    "phi_mean": float(blk[:, 5 + n_bands].mean()),
                })
            catalog.append(CatalogEntry(kind=kind, p_star=cand[i]["p"], du_mean=du.mean(0),
                                        du_std=du.std(0), flux_mean=flux.mean(0),
                                        flux_std=flux.std(0), extras=extras))
    logger.log("sample", n_groups=n_groups, rhat_max=max(d["rhat_max"] for d in diag),
               ess_min=min(d["ess_min"] for d in diag),
               divergence_max=max(d["divergence_rate"] for d in diag))
    artifacts = {"n_sources": len(catalog), "n_groups": n_groups, "groups": members,
                 "samples": samples, "group_cut": gcut, "diagnostics": diag, "s_max": s_max}
    return catalog, artifacts


def _group_logdensity(fr: _Frames, sets, flg, alv):
    """The fit groups' joint log density ``[G R, S_max (6 + B)] -> [G R]``:
    group g's R rows (its chains, set-major) are rectangular states of
    S_max sources whose kinds ``flg`` and liveness ``alv`` [G, S_max] are
    data, rendered through ``mixed_field_planes`` with the dead rows'
    amplitudes zeroed, on group g's pixel set of every frame (``sets``:
    one [G, PIX_PAD] tuple per frame, the neighbour groups' lambdas in its
    effective sky), with K1's centered likelihood, plus
    ``_mixed_rect_logprior``."""
    n_groups, s_max = flg.shape
    gd = GAL_D(fr.nb)

    def logd(x):
        rows = x.shape[0]
        rect = x.reshape(rows * s_max, gd)
        rep = rows // n_groups
        fl = flg[:, None, :].expand(-1, rep, -1).reshape(rows, s_max)
        al = alv[:, None, :].expand(-1, rep, -1).reshape(rows, s_max)
        ll = 0.0
        for f, pd in enumerate(sets):
            planes = fr.planes(rect, f, "mixed", fl.reshape(-1))
            amp = planes[0].reshape(rows, s_max, -1) * al[..., None]
            flat = (amp.reshape(rows, -1),) + tuple(p.reshape(rows, -1) for p in planes[1:])
            ll = ll + mog_field_loglik(*flat, pd, centered=True)
        return ll + _mixed_rect_logprior(rect.reshape(rows, s_max, gd), fl, al, fr.priors,
                                         fr.nb)

    return logd


def _det_fit_batch(fr: _Frames, cfg: FieldConfig, x0s, sets, n_pix: int):
    """Batched detection-stage star MAPs on residual-count cutouts, one row
    per candidate (R = 1).  Returns (x_maps [N, ds] NumPy, sky-free fit
    lambdas [N, nf, n_pix] NumPy)."""
    xm, _ = map_fit(fr.logdensity("star", sets), x0s, n_steps=cfg.map_steps)
    lams = torch.stack([fr.render(fr.planes(xm, f, "star"), pd, n_pix)
                        for f, pd in enumerate(sets)], dim=1)
    return xm.cpu().numpy(), lams.cpu().numpy().astype(np.float64)


def _classify_batch(fr: _Frames, cfg: FieldConfig, rects, sets, eff, cut_data):
    """One Jacobi sweep over every candidate: its star fit and evidence, its
    galaxy fit and evidence (rows 2 j and 2 j + 1, R = 2; the Laplace
    Hessians of all rows in one more batch) and the source-free evidence,
    against the effective skies ``eff`` [N, nf, P].  Returns NumPy (x_star
    [N, ds], lz_s [N], x_gal [N, gd], lz_g [N], lz_0 [N])."""
    n = rects.shape[0]
    ds = STAR_D(fr.nb)
    if cfg.classify:
        logd = fr.logdensity("mixed", sets, is_star=[True, False] * n)
        x_fit, _ = map_fit(logd, rects.repeat_interleave(2, dim=0), n_steps=cfg.map_steps)
        logp, h = hessian_fd(logd, x_fit)
        lz_s = laplace_from_hessian(logp[0::2], h[0::2, :ds, :ds])
        lz_g = laplace_from_hessian(logp[1::2], h[1::2])
        xs, xg = x_fit[0::2, :ds], x_fit[1::2]
    else:
        logd = fr.logdensity("star", sets)
        xs, _ = map_fit(logd, rects[:, :ds], n_steps=cfg.map_steps)
        logp, h = hessian_fd(logd, xs)
        lz_s = laplace_from_hessian(logp, h)
        xg = torch.zeros_like(rects)
        lz_g = torch.full_like(lz_s, -float("inf"))
    # the source-free evidence: sum over frames and pixels, float32
    cts = torch.stack([pd[2] for pd in cut_data], dim=1)
    mk = torch.stack([pd[4] for pd in cut_data], dim=1)
    lz_0 = torch.sum((cts * torch.log(eff) - eff) * mk, dim=(1, 2))
    lz = torch.stack([lz_s, lz_g, lz_0]).cpu().numpy()
    return xs.cpu().numpy(), lz[0], xg.cpu().numpy(), lz[1], lz[2]


def _groups_axis(mesh):
    """(ranks along ``groups``, this rank's index) of ``mesh`` (1, 0 without)."""
    from celeste_tpu_torch.parallel.mesh import axis_index, axis_size

    return axis_size(mesh, "groups"), axis_index(mesh, "groups")


def _gather_groups(mesh, samples, infos, first: int, g_all: int, n_chains: int):
    """Every rank's groups' samples [G_loc B, n, D] and infos ([G_loc, n]
    fields) into the whole batch's, by one all-reduce each of a zero-padded
    buffer over ``groups``; without a mesh, the arrays as they are."""
    from celeste_tpu_torch.parallel.collectives import all_reduce_sum

    n_ranks, _ = _groups_axis(mesh)
    if n_ranks == 1:
        return samples, infos

    def fill(x, rows):
        buf = x.new_zeros((rows,) + tuple(x.shape[1:]))
        lo = first * (rows // g_all)
        buf[lo:lo + x.shape[0]] = x
        return all_reduce_sum(buf, mesh, "groups")

    return (fill(samples, g_all * n_chains),
            ChEESInfo(*(fill(t, g_all) for t in infos)))
