"""Empirical GMM prior over colours (counterpart of
``celeste_tpu/model/color_prior.py``).

The flux prior of config 2 is a log-normal on the reference band plus a
mixture over the adjacent-band colours c_b = log(f_b / f_{b+1}): stars and
galaxies occupy curved loci in colour space that one Gaussian misses.

``ColorGMM`` holds plain tuples (the JAX package's fields, so ``interop``
carries one across as it is); ``logpdf`` is a logsumexp of full-covariance
Gaussian components, with the small triangular product written as a
broadcast multiply-sum (no matmul, so no TF32 path on the card).
``fit_color_gmm`` is the JAX package's NumPy EM, copied as it is, so the
default mixtures of the two packages are equal.

Provenance: with no survey catalogue at hand, ``default_star_gmm`` and
``default_galaxy_gmm`` are fits to synthetic populations shaped like the
SDSS stellar locus and the red/blue galaxy bimodality.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_LOG2PI = 1.8378770664093453


@dataclass(frozen=True)
class ColorGMM:
    """K-component full-covariance GMM over C-dimensional colour vectors.

    weights   [K]        mixture weights (sum to 1)
    means     [K][C]
    inv_chols [K][C][C]  inverses of the lower Cholesky factors
    """

    weights: tuple
    means: tuple
    inv_chols: tuple

    @property
    def n_comp(self):
        return len(self.weights)

    @property
    def n_dim(self):
        return len(self.means[0])

    def logpdf(self, colors):
        """``colors`` [..., C] -> [...] log density.

        With fewer colours than the mixture's C (few-band problems) it
        marginalises onto the leading dimensions: the marginal of a mixture
        is the mixture of marginals, and the leading block of L^-1 is the
        inverse Cholesky factor of the leading covariance block (L is lower
        triangular), so truncating ``inv_chols`` is exact."""
        c = colors.shape[-1]
        kw = dict(dtype=torch.float32, device=colors.device)
        w = torch.as_tensor(self.weights, **kw)
        mu = torch.as_tensor(self.means, **kw)[:, :c]
        ichol = torch.as_tensor(self.inv_chols, **kw)[:, :c, :c]
        diff = colors[..., None, :] - mu                          # [..., K, C]
        z = torch.sum(ichol * diff[..., None, :], dim=-1)         # [..., K, C]
        maha = torch.sum(z * z, dim=-1)                           # [..., K]
        # log det(Sigma)^-1/2 = sum log diag(L^-1)
        half_logdet_prec = torch.sum(torch.log(torch.diagonal(ichol, dim1=-2, dim2=-1)), dim=-1)
        comp = -0.5 * (maha + c * _LOG2PI) + half_logdet_prec
        return torch.logsumexp(comp + torch.log(w), dim=-1)

    @classmethod
    def from_arrays(cls, weights, means, covs):
        weights = np.asarray(weights, np.float64)
        weights = weights / weights.sum()
        chols = np.linalg.cholesky(np.asarray(covs, np.float64))
        inv_chols = np.stack([np.linalg.inv(L) for L in chols])
        return cls(
            weights=tuple(float(x) for x in weights),
            means=tuple(tuple(float(v) for v in m) for m in means),
            inv_chols=tuple(tuple(tuple(float(v) for v in row) for row in L)
                            for L in inv_chols),
        )


def _mvn_logpdf_np(x, mu, cov):
    """[N, C] Gaussian log-density, NumPy (EM inner loop)."""
    c = x.shape[1]
    L = np.linalg.cholesky(cov)
    z = np.linalg.inv(L) @ (x - mu).T                     # [C, N]
    return (-0.5 * np.sum(z * z, 0) - np.log(np.diag(L)).sum()
            - 0.5 * c * _LOG2PI)


def fit_color_gmm(colors, n_comp: int = 4, n_iter: int = 200, seed: int = 0,
                  ridge: float = 1e-4):
    """Plain-NumPy EM for a full-covariance GMM on ``colors`` [N, C].
    Returns a ``ColorGMM``.  Deterministic given ``seed`` (kmeans++-style
    init from the data)."""
    x = np.asarray(colors, np.float64)
    n, c = x.shape
    rng = np.random.default_rng(seed)

    # kmeans++ init for the means
    means = [x[rng.integers(n)]]
    for _ in range(1, n_comp):
        d2 = np.min([np.sum((x - m) ** 2, 1) for m in means], axis=0)
        means.append(x[rng.choice(n, p=d2 / d2.sum())])
    mu = np.stack(means)                         # [K, C]
    cov = np.tile((np.cov(x.T) + ridge * np.eye(c)).reshape(1, c, c), (n_comp, 1, 1))
    w = np.full(n_comp, 1.0 / n_comp)

    for _ in range(n_iter):
        logp = np.stack([_mvn_logpdf_np(x, mu[k], cov[k]) + np.log(w[k])
                         for k in range(n_comp)], axis=1)   # [N, K]
        m = logp.max(1, keepdims=True)
        r = np.exp(logp - m)
        r /= r.sum(1, keepdims=True)
        nk = r.sum(0) + 1e-12
        w = nk / n
        mu = (r.T @ x) / nk[:, None]
        for k in range(n_comp):
            d = x - mu[k]
            cov[k] = (r[:, k, None] * d).T @ d / nk[k] + ridge * np.eye(c)
    return ColorGMM.from_arrays(w, mu, cov)


def synthetic_star_colors(n: int = 4000, seed: int = 1):
    """Synthetic star colours along a curved stellar-locus-like arc, in the
    convention c_b = ln(f_b / f_{b+1}); centred so the synthetic scenes'
    default SED (``data.synthetic.star_source``) lies mid-locus."""
    rng = np.random.default_rng(seed)
    t = rng.beta(2.0, 2.0, n)                    # temperature-ish, mid 0.5
    ug = -1.60 + 1.50 * t
    gr = -0.70 + 0.70 * t - 0.20 * t * t
    ri = -0.35 + 0.45 * t - 0.10 * t * t
    iz = -0.15 + 0.25 * t - 0.05 * t * t
    cols = np.stack([ug, gr, ri, iz], 1)
    return cols + rng.normal(0, [0.11, 0.06, 0.05, 0.06], (n, 4))


def synthetic_galaxy_colors(n: int = 4000, seed: int = 2):
    """Red-sequence / blue-cloud bimodality in the g-r ln-flux ratio with
    correlated scatter; centred on the synthetic scenes' default galaxy SED."""
    rng = np.random.default_rng(seed)
    red = rng.random(n) < 0.45
    gr = np.where(red, rng.normal(-0.70, 0.07, n), rng.normal(-0.40, 0.13, n))
    ug = 1.1 * (gr + 0.5) - 0.85 + rng.normal(0.0, 0.18, n)
    ri = 0.45 * (gr + 0.5) - 0.25 + rng.normal(0.0, 0.07, n)
    iz = 0.55 * (ri + 0.25) - 0.14 + rng.normal(0.0, 0.06, n)
    return np.stack([ug, gr, ri, iz], 1)


_DEFAULT_CACHE = {}


def default_star_gmm(n_comp: int = 4) -> ColorGMM:
    """Deterministic synthetic-population star colour GMM (cached)."""
    key = ("star", n_comp)
    if key not in _DEFAULT_CACHE:
        _DEFAULT_CACHE[key] = fit_color_gmm(synthetic_star_colors(), n_comp=n_comp, seed=11)
    return _DEFAULT_CACHE[key]


def default_galaxy_gmm(n_comp: int = 4) -> ColorGMM:
    """Deterministic synthetic-population galaxy colour GMM (cached)."""
    key = ("galaxy", n_comp)
    if key not in _DEFAULT_CACHE:
        _DEFAULT_CACHE[key] = fit_color_gmm(synthetic_galaxy_colors(), n_comp=n_comp, seed=12)
    return _DEFAULT_CACHE[key]
