"""Photometric flux projection (counterpart of
``celeste_tpu/quasar/photometry.py``; the reference's ``project_to_bands``:
redshift the rest-frame SED, integrate against each band's throughput).

Math (Miller et al. 2015): with rest SED f_rest(lam) = sum_b w_b B_b(lam),
observed-frame f_obs(lam) = m * f_rest(lam / (1+z)), photon-counting band
flux = sum_lam f_obs(lam) * resp(lam) * lam * dlam (resp pre-normalized in
FilterBank).  The basis is linearly interpolated at lam/(1+z) by
:func:`interp`, ``jnp.interp``'s formula on ``torch.searchsorted``
(differentiable in z through the query positions).

Every contraction here is a broadcast multiply and sum in float32: a
matmul would run in TF32 on a card that allows it, and these sums decide
model fluxes at the 1e-3 level (the JAX package takes them at
``Precision.HIGHEST`` for the same reason).  Redshifts broadcast: ``z``
[...] gives [..., n_bands, K] matrices and [..., n_bands] fluxes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from celeste_tpu_torch.quasar.basis import QuasarBasis
from celeste_tpu_torch.quasar.filters import FilterBank

GRID_CHUNK = 512     # redshifts per step of the table's build


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp, left=0, right=0)`` for the rows of ``fp``: ``xp``
    [L] sorted, ``fp`` [..., L], ``x`` any shape; returns fp.shape[:-1] +
    x.shape.  The same formula as JAX's: the segment i = clip(searchsorted
    (xp, x, right), 1, L-1), f = fp[i-1] + (x - xp[i-1]) / dx * df, and
    0 outside [xp[0], xp[-1]]; its gradient in ``x`` is the segment's
    slope."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, dx = xp[i - 1], xp[i] - xp[i - 1]
    f0 = fp[..., i - 1]
    df = fp[..., i] - f0
    eps = torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps   # np.spacing(eps), JAX's cut
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    return torch.where((x < xp[0]) | (x > xp[-1]), torch.zeros_like(f), f)


def basis_band_matrix(basis: QuasarBasis, filters: FilterBank, z):
    """[..., n_bands, K] matrices M(z): band flux of each unit basis spectrum
    at redshift z [...].  flux = m * M(z) @ w."""
    z = torch.as_tensor(z, dtype=filters.lam.dtype, device=filters.lam.device)
    query = filters.lam / (1.0 + z[..., None, None])              # [..., n_bands, n_pts]
    fvals = interp(query, basis.lam_rest, basis.b)                # [K, ..., n_bands, n_pts]
    weights = filters.resp * filters.lam * filters.dlam           # [n_bands, n_pts]
    mat = torch.sum(fvals * weights, dim=-1)                      # [K, ..., n_bands]
    return torch.movedim(mat, 0, -1)


def _apply(mat, w, m):
    """m * M @ w as a broadcast sum: ``mat`` [..., n_bands, K], ``w`` [..., K]."""
    m = torch.as_tensor(m, dtype=mat.dtype, device=mat.device)
    return m[..., None] * torch.sum(mat * w[..., None, :], dim=-1)


def project_to_bands(basis: QuasarBasis, filters: FilterBank, w, m, z):
    """Model band fluxes [..., n_bands] for simplex weights w [..., K],
    scales m [...], redshifts z [...]."""
    return _apply(basis_band_matrix(basis, filters, z), w, m)


class BandMatrixGrid(NamedTuple):
    """``basis_band_matrix`` precomputed on a uniform z grid.

    The exact projection rebuilds the [n_bands, K] matrix at every
    likelihood evaluation: K interpolations of n_bands * n_pts query points
    into the template table.  M(z) is a fixed function of (basis, filters),
    piecewise smooth in z, so it is tabulated once on a uniform grid and
    the ~20 matrix entries are interpolated per evaluation instead: index
    arithmetic and one small gather, differentiable in z through the
    interpolation weight.  At the PhotoZConfig default of 8192 points over
    z in [0, 6] the model fluxes stay within a small fraction of a
    3%-photometry sigma of the exact path (the JAX package's test gates
    < 10%, and its measurement says 3%).
    """

    table: torch.Tensor    # [n_z, n_bands, K]
    z_max: float
    n_basis: int

    def to(self, device) -> "BandMatrixGrid":
        return self._replace(table=self.table.to(device))


def _linspace(stop: float, n: int, device):
    """[0, stop] in n float32 points, by ``jnp.linspace``'s formula."""
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    stop_t = torch.tensor(float(stop), dtype=torch.float32, device=device)
    return torch.cat([stop_t * step, stop_t[None]])


def band_matrix_grid(basis: QuasarBasis, filters: FilterBank, z_max: float = 6.0,
                     n_z: int = 8192) -> BandMatrixGrid:
    """Tabulate ``basis_band_matrix`` on ``n_z`` uniform redshifts in
    [0, z_max], ``GRID_CHUNK`` redshifts at a time (the [chunk, K, n_bands,
    n_pts] interpolation is the memory).  The table is built on the CPU,
    so it is the same table on every device (a card's division by a
    scalar moves a knot by an ulp, and the templates' lines are steep
    enough to carry that to ~1e-5 of an entry), and is held on the
    basis's device."""
    cpu = torch.device("cpu")
    basis_c, filters_c = basis.to(cpu), filters.to(cpu)
    zs = _linspace(z_max, int(n_z), cpu)
    with torch.no_grad():
        table = torch.cat([basis_band_matrix(basis_c, filters_c, zs[i:i + GRID_CHUNK])
                           for i in range(0, zs.shape[0], GRID_CHUNK)])
    return BandMatrixGrid(table=table.to(basis.b.device), z_max=float(z_max),
                          n_basis=int(basis.n_basis))


def project_to_bands_grid(grid: BandMatrixGrid, w, m, z):
    """Grid-accelerated :func:`project_to_bands`: linear interpolation of the
    tabulated band matrix in z (w [..., K], m [...], z [...] -> [...,
    n_bands]).  The floor index is clipped to [0, n_z - 2] and its weight
    to [0, 1], as the JAX package clips them."""
    n_z = grid.table.shape[0]
    dz = grid.z_max / (n_z - 1)
    t = z / dz
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n_z - 2)
    frac = torch.clamp(t - i0.to(t.dtype), 0.0, 1.0)[..., None, None]
    # T0 + frac (T1 - T0): the knots' difference is taken exactly (Sterbenz),
    # so the z-gradient carries the table's slope without the cancellation
    # of (1 - frac) T0 + frac T1, whose two cotangent sums cancel to ~1e-3
    t0 = grid.table[i0]
    mat = t0 + frac * (grid.table[i0 + 1] - t0)
    return _apply(mat, w, m)
