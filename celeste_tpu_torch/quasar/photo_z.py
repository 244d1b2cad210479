"""Photometric-redshift posterior (counterpart of
``celeste_tpu/quasar/photo_z.py``; BASELINE config 4, the reference's
``quasar_infer_photometry``: slice sampling within parallel tempering over
p(z, w, m | ugriz fluxes)).

Parameterization (unconstrained [D = 1 + (K-1) + 1] vector):
  zeta        -> z = z_max * sigmoid(zeta)          (+ log-Jacobian)
  eta [K-1]   -> w = softmax([eta, 0])              (ALR, last coord pinned)
  log_m       -> m = exp(log_m)                     (+ log-Jacobian)

The z posterior is multimodal (continuum colours alias across redshift;
Ly-alpha crossing bands creates distinct modes), hence the tempered ladder
(``inference.tempering``).  Batch-major: the states of a run are [S, T, D]
(systems x temperatures), and [N, S, T, D] for a batch of N targets, one
chain batch for the inner kernels.

Random streams (``utils.rng``, under the run's seed):

- ``run_photo_z`` and ``run_photo_z_sharded`` draw everything from one
  stream, so the sharded ladder is the in-device one;
- the batched runs draw each target's start, and for the HMC inners its
  warmup and sampling noise, from the target's own streams (seed, kind,
  target, block), in blocks of ``DRAW_BLOCK`` steps at a block's whole
  shape (one call per target, kind and block): a target's chain does not
  depend on the batch it rides in nor on where segments end.  The
  lockstep slice inner draws a data-dependent count of uniforms for the
  whole batch, so its chains follow one stream (seed, sampling): segment
  boundaries stay invisible, but a target's slice chain depends on its
  batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from celeste_tpu_torch.inference.tempering import (
    geometric_ladder, hmc_at_beta, hmc_at_beta_adaptive, pt_init, pt_kernel, pt_warmup,
    slice_at_beta,
)
from celeste_tpu_torch.quasar.basis import QuasarBasis
from celeste_tpu_torch.quasar.filters import FilterBank
from celeste_tpu_torch.quasar.photometry import (
    BandMatrixGrid, band_matrix_grid, project_to_bands, project_to_bands_grid,
)
from celeste_tpu_torch.utils.rng import seeded_generator

INNERS = ("slice", "hmc", "hmc_adaptive")
# stream kinds under a run's seed, and the steps per drawn block
_INIT, _WARM, _RUN = 0, 1, 2
DRAW_BLOCK = 50


@dataclass(frozen=True)
class PhotoZConfig:
    z_max: float = 6.0
    log_m_mean: float = 0.0
    log_m_std: float = 3.0
    eta_std: float = 2.0
    n_temps: int = 8
    beta_min: float = 0.02
    n_steps: int = 1500
    n_warmup: int = 500
    n_systems: int = 8        # independent tempering systems
    # 'slice' (reference parity), 'hmc' (gradient, beta^(-1/4) step
    # heuristic), or 'hmc_adaptive' (per-replica dual-averaging warmup)
    inner: str = "slice"
    hmc_step_size: float = 0.01
    hmc_n_leapfrog: int = 8
    pt_warmup_steps: int = 150   # hmc_adaptive only
    # > 0: tabulate basis_band_matrix on this many uniform redshifts once
    # per run and interpolate the table per evaluation
    # (photometry.BandMatrixGrid); 0 recomputes the exact projection
    flux_grid_n: int = 8192


def split_vec(vec, n_basis: int):
    return vec[..., 0], vec[..., 1:n_basis], vec[..., n_basis]


def constrain(vec, n_basis: int, z_max: float):
    zeta, eta, log_m = split_vec(vec, n_basis)
    z = z_max * torch.sigmoid(zeta)
    w = torch.softmax(torch.cat([eta, torch.zeros_like(eta[..., :1])], dim=-1), dim=-1)
    return z, w, torch.exp(log_m)


def make_photo_z_logdensity(basis: QuasarBasis, filters: FilterBank, flux_obs, flux_err,
                            cfg: PhotoZConfig = PhotoZConfig(),
                            grid: BandMatrixGrid | None = None):
    """Unconstrained log posterior of targets' observed fluxes: ``flux_obs``
    and ``flux_err`` [n_bands] (one target) or [N, n_bands] (a batch); the
    density maps vec [..., D] -> [...], a batch's leading axis the target's.
    ``grid``: a prebuilt :class:`BandMatrixGrid`; with ``grid=None`` and
    ``cfg.flux_grid_n > 0`` it is built here."""
    device = basis.b.device
    fo = torch.as_tensor(flux_obs, dtype=torch.float32, device=device)
    fe = torch.as_tensor(flux_err, dtype=torch.float32, device=device)
    k = basis.n_basis
    if grid is None and cfg.flux_grid_n > 0:
        grid = band_matrix_grid(basis, filters, cfg.z_max, cfg.flux_grid_n)

    def logdensity(vec):
        zeta, eta, log_m = split_vec(vec, k)
        z, w, m = constrain(vec, k, cfg.z_max)
        model = (project_to_bands_grid(grid, w, m, z) if grid is not None
                 else project_to_bands(basis, filters, w, m, z))
        # a batch's fluxes [N, n_bands] against vec's [N, ..., n_bands]
        pad = (1,) * (model.dim() - fo.dim())
        obs = fo.reshape(fo.shape[:-1] + pad + fo.shape[-1:])
        err = fe.reshape(fe.shape[:-1] + pad + fe.shape[-1:])
        resid = (obs - model) / err
        ll = -0.5 * torch.sum(resid * resid, dim=-1)
        # priors: z flat on (0, z_max) -> the sigmoid's log-Jacobian, as
        # log sigmoid(zeta) + log sigmoid(-zeta) (logsigmoid: finite where
        # JAX's log(sigmoid) underflows, equal where that is finite); eta
        # Gaussian (weakly-informative simplex smoothing); log_m Gaussian
        ljd_z = F.logsigmoid(zeta) + F.logsigmoid(-zeta)
        lp_eta = -0.5 * torch.sum((eta / cfg.eta_std) ** 2, dim=-1)
        lp_m = -0.5 * ((log_m - cfg.log_m_mean) / cfg.log_m_std) ** 2
        return ll + ljd_z + lp_eta + lp_m

    return logdensity


def _check_inner(cfg: PhotoZConfig):
    if cfg.inner not in INNERS:
        raise ValueError(f"unknown inner kernel {cfg.inner!r}; use 'slice', 'hmc', or "
                         f"'hmc_adaptive'")


def _inner(cfg: PhotoZConfig, logd, d, device, ss=None, im=None, noise=None):
    """The inner kernel family of ``cfg.inner`` (unit widths for slice, unit
    mass and ``hmc_step_size`` for hmc, the warmup's (ss, im) for
    hmc_adaptive)."""
    if cfg.inner == "slice":
        return slice_at_beta(logd, torch.ones(d, device=device), noise=noise)
    if cfg.inner == "hmc":
        return hmc_at_beta(logd, cfg.hmc_step_size, torch.ones(d, device=device),
                           n_leapfrog=cfg.hmc_n_leapfrog, noise=noise)
    return hmc_at_beta_adaptive(logd, ss, im, n_leapfrog=cfg.hmc_n_leapfrog, noise=noise)


def _init_scale(k, device):
    """The start's spread: zeta (the redshift) over [2.0], the rest [1.0]."""
    return torch.tensor([2.0] + [1.0] * k, dtype=torch.float32, device=device)


def _prepare(basis, filters, grid, cfg, device):
    """Resolve the device (CUDA unless asked; raises where it is absent) and
    move the basis, filters and grid there, building the grid if needed."""
    from celeste_tpu_torch.experiments import resolve_device

    _check_inner(cfg)
    device = resolve_device(str(device))
    basis, filters = basis.to(device), filters.to(device)
    if grid is None and cfg.flux_grid_n > 0:
        grid = band_matrix_grid(basis, filters, cfg.z_max, cfg.flux_grid_n)
    return device, basis, filters, None if grid is None else grid.to(device)


class _Counted:
    """A log density that counts its batched calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def _summary(cold_xs, swaps, active, n_burn, cfg, k):
    """The run's dict from the cold chain [..., n_done, D] and the swap
    records [..., n_done, T-1] (``active`` [n_done, T-1])."""
    kept = cold_xs[..., n_burn:, :]
    z, w, m = constrain(kept, k, cfg.z_max)
    # acceptance among attempted swaps (one parity class attempts per step)
    n_att = torch.sum(active.to(torch.float32)) * (swaps[..., 0, 0].numel())
    return {"z": z, "w": w, "m": m, "vec": kept,
            "swap_rate": torch.sum(swaps.to(torch.float32)) / torch.clamp(n_att, min=1.0)}


def _run_ladder(seed, basis, filters, flux_obs, flux_err, cfg, grid, device, mesh, axis_name):
    """One target's S tempering systems from one stream: the start [S, T, D],
    the warmup (hmc_adaptive), then ``cfg.n_steps`` tempered steps, in
    device (``mesh=None``) or with the ladder sharded over
    ``mesh[axis_name]``.  Returns ``run_photo_z``'s dict."""
    from celeste_tpu_torch.parallel.pt_sharded import (
        LadderShard, from_first_rank, sharded_pt_init, sharded_pt_kernel,
    )

    device, basis, filters, grid = _prepare(basis, filters, grid, cfg, device)
    logd = _Counted(make_photo_z_logdensity(basis, filters, flux_obs, flux_err, cfg, grid=grid))
    k = basis.n_basis
    d = k + 1
    betas = geometric_ladder(cfg.n_temps, cfg.beta_min, device)
    gen = seeded_generator(device, seed)
    xs = torch.randn((cfg.n_systems, cfg.n_temps, d), generator=gen, device=device) * \
        _init_scale(k, device)
    ss = im = None
    with torch.no_grad():
        if cfg.inner == "hmc_adaptive":
            xs, ss, im = pt_warmup(gen, logd, xs, betas, n_warmup=cfg.pt_warmup_steps,
                                   n_leapfrog=cfg.hmc_n_leapfrog)
        if mesh is None:
            kern = pt_kernel(logd, _inner(cfg, logd, d, device, ss, im), betas)
            state = pt_init(xs, logd)
        else:
            noise = LadderShard(mesh, axis_name, cfg.n_temps)
            kern = sharded_pt_kernel(logd, _inner(cfg, logd, d, device, ss, im, noise), betas,
                                     mesh, axis_name=axis_name)
            state = sharded_pt_init(xs, logd, mesh, axis_name)
        logd.calls = 0
        cold, swaps, active = [], [], []
        for _ in range(cfg.n_steps):
            state, info = kern(gen, state)
            # the cold replica: local replica 0 of the ladder's first rank
            cold.append(state.xs[..., 0, :])
            swaps.append(info.swap_accept)
            active.append(info.swap_active)
    cold = torch.stack(cold, dim=-2)
    if mesh is not None:
        cold = from_first_rank(cold, mesh, axis_name)
    out = _summary(cold, torch.stack(swaps, dim=-2), torch.stack(active), cfg.n_warmup, cfg, k)
    out["calls_per_sweep"] = logd.calls / cfg.n_steps
    return out


def run_photo_z(seed: int, basis: QuasarBasis, filters: FilterBank, flux_obs, flux_err,
                cfg: PhotoZConfig = PhotoZConfig(), grid: BandMatrixGrid | None = None,
                device="cuda"):
    """Tempered ensemble of ``cfg.n_systems`` systems for one target (the
    reference's sampler family with ``inner="slice"``).

    Returns a dict with the cold chain's kept draws: z [S, n_kept], w [S,
    n_kept, K], m, vec [S, n_kept, D]; ``swap_rate`` (acceptance among
    attempted swaps) and ``calls_per_sweep`` (batched log-density calls per
    tempered step: the lockstep slice's sweeps).  Runs on the card unless
    ``device="cpu"``."""
    return _run_ladder(seed, basis, filters, flux_obs, flux_err, cfg, grid, device, None,
                       "temps")


def run_photo_z_sharded(seed: int, basis: QuasarBasis, filters: FilterBank, flux_obs,
                        flux_err, mesh, cfg: PhotoZConfig = PhotoZConfig(),
                        axis_name: str = "temps", grid: BandMatrixGrid | None = None,
                        device="cuda"):
    """``run_photo_z`` with the temperature ladder sharded over
    ``mesh[axis_name]`` (``parallel.pt_sharded``): every rank draws the
    whole ladder's random numbers from the one stream and keeps its
    replicas, and the warmup runs whole on every rank, so the result is
    ``run_photo_z``'s.  Every rank returns the same dict."""
    return _run_ladder(seed, basis, filters, flux_obs, flux_err, cfg, grid, device, mesh,
                       axis_name)


class TargetDraws:
    """The random numbers of a batch of targets' tempered runs, drawn per
    target: the ``noise`` of the inner kernels and the swap sweep.

    Each step consumes the draws of ``schedule`` in order, a list of
    ("normal" | "uniform", per-target shape); ``normal(gen, like)`` and
    ``uniform(gen, like)`` hand out the next one (``gen`` unused) as [N,
    *shape] reshaped to ``like``.  Step i of target t lies in block i //
    DRAW_BLOCK, drawn from the stream (seed, kind, t, block) at the block's
    whole shape, one call per target and draw of the schedule."""

    def __init__(self, seed, kind, n_targets, schedule, device):
        self.seed, self.kind, self.n_targets = seed, kind, n_targets
        self.schedule, self.device = schedule, device
        self._blocks, self._loaded, self._queue, self._step = None, -1, [], 0

    def _draw_block(self, b):
        per_target = []
        for t in range(self.n_targets):
            gen = seeded_generator(self.device, self.seed, self.kind, t, b)
            draw = {"normal": torch.randn, "uniform": torch.rand}
            per_target.append([draw[kind]((DRAW_BLOCK,) + tuple(shape), generator=gen,
                                          device=self.device)
                               for kind, shape in self.schedule])
        self._blocks = [torch.stack(parts, dim=1) for parts in zip(*per_target)]
        self._loaded = b

    def _next(self, kind, like):
        if not self._queue:
            b, i = divmod(self._step, DRAW_BLOCK)
            if b != self._loaded:
                self._draw_block(b)
            self._queue = [(k, blk[i]) for (k, _), blk in zip(self.schedule, self._blocks)]
            self._step += 1
        got, x = self._queue.pop(0)
        if got != kind or x.numel() != like.numel():
            raise RuntimeError(f"draw order: asked for {kind} {tuple(like.shape)}, next is "
                               f"{got} {tuple(x.shape)}")
        return x.reshape(like.shape).to(like.dtype)

    def normal(self, gen, like):
        return self._next("normal", like)

    def uniform(self, gen, like):
        return self._next("uniform", like)

    def seek(self, step: int):
        """Continue at step ``step`` (the start of a segment)."""
        self._step, self._queue = int(step), []


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_photo_z_batch_segmented(seed: int, basis: QuasarBasis, filters: FilterBank,
                                flux_obs, flux_err, cfg: PhotoZConfig = PhotoZConfig(),
                                segment_steps: int = 100, deadline_fn=None, device="cuda"):
    """A batch of independent targets (``flux_obs``/``flux_err`` [N,
    n_bands]), ``cfg.n_systems`` systems each, in one chain batch [N, S, T,
    D], sampled in segments of ``segment_steps`` steps.

    Each target draws from its own streams (module docstring), so with
    the HMC inners a target's chain is bitwise the same in any batch, and
    for every inner any ``segment_steps`` gives bitwise the same samples.  The warmup
    (hmc_adaptive) runs before the first segment.  ``deadline_fn`` (() ->
    bool) is consulted between segments; when it returns False the run
    stops with the segments done so far (at least one runs), a prefix of
    the full run's samples.

    Returns ``run_photo_z``'s dict with a leading [N] axis (z [N, S,
    n_kept], ...), plus ``n_steps_done`` and ``timings`` (``init_s``, the
    warmup, and ``segment_s``, each segment's seconds, synchronised)."""
    device, basis, filters, grid = _prepare(basis, filters, None, cfg, device)
    n, k = np.shape(flux_obs)[0], basis.n_basis
    d = k + 1
    s_, t_ = cfg.n_systems, cfg.n_temps
    logd = make_photo_z_logdensity(basis, filters, flux_obs, flux_err, cfg, grid=grid)
    betas = geometric_ladder(t_, cfg.beta_min, device)
    hmc = cfg.inner != "slice"

    t0 = time.perf_counter()
    xs = torch.stack([torch.randn((s_, t_, d), generator=seeded_generator(device, seed, _INIT, t),
                                  device=device) for t in range(n)]) * _init_scale(k, device)
    ss = im = None
    with torch.no_grad():
        if cfg.inner == "hmc_adaptive":
            warm = TargetDraws(seed, _WARM, n, [("normal", (s_, t_, d)), ("uniform", (s_, t_))],
                               device)
            xs, ss, im = pt_warmup(None, logd, xs, betas, n_warmup=cfg.pt_warmup_steps,
                                   n_leapfrog=cfg.hmc_n_leapfrog, noise=warm)
        state = pt_init(xs, logd)
    _sync(device)
    init_s = time.perf_counter() - t0

    if hmc:
        draws = TargetDraws(seed, _RUN, n, [("normal", (s_, t_, d)), ("uniform", (s_, t_)),
                                              ("uniform", (s_, t_ - 1))], device)
        kern, gen = pt_kernel(logd, _inner(cfg, logd, d, device, ss, im, draws), betas,
                              noise=draws), None
    else:
        kern = pt_kernel(logd, _inner(cfg, logd, d, device), betas)
        gen = seeded_generator(device, seed, _RUN)
    cold, swaps, active, seg_times = [], [], [], []
    with torch.no_grad():
        for off in range(0, cfg.n_steps, segment_steps):
            if cold and deadline_fn is not None and not deadline_fn():
                break
            t0 = time.perf_counter()
            if hmc:
                draws.seek(off)
            for _ in range(off, min(off + segment_steps, cfg.n_steps)):
                state, info = kern(gen, state)
                cold.append(state.xs[..., 0, :])
                swaps.append(info.swap_accept)
                active.append(info.swap_active)
            _sync(device)
            seg_times.append(time.perf_counter() - t0)
    n_done = len(cold)
    # a deadline before the configured burn-in ends keeps the last quarter
    burn = cfg.n_warmup if n_done > cfg.n_warmup else (3 * n_done) // 4
    out = _summary(torch.stack(cold, dim=-2), torch.stack(swaps, dim=-2), torch.stack(active),
                   burn, cfg, k)
    out.update(n_steps_done=n_done, timings={"init_s": init_s, "segment_s": seg_times})
    return out


def run_photo_z_batch(seed: int, basis: QuasarBasis, filters: FilterBank, flux_obs, flux_err,
                      cfg: PhotoZConfig = PhotoZConfig(), device="cuda"):
    """A batch of independent targets [N, n_bands] in one run
    (``run_photo_z_batch_segmented`` in one segment); returns ``run_photo_z``'s
    dict with a leading [N] axis."""
    out = run_photo_z_batch_segmented(seed, basis, filters, flux_obs, flux_err, cfg,
                                      segment_steps=cfg.n_steps, device=device)
    return {key: out[key] for key in ("z", "w", "m", "vec", "swap_rate")}
