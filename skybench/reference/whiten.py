"""The whitened space worked out again from the probe's draws, in float64:
the pooled mean and covariance with a relative ridge on the diagonal (the
configuration's ``probe_ridge``), and the map x = m + L z with L its
Cholesky factor."""

from __future__ import annotations

import torch


def pooled_moments(draws, ridge: float):
    """(mean [D], cov [D, D]) of draws [..., D] pooled over every leading
    axis, with ``ridge`` times the largest variance added to the diagonal."""
    flat = draws.reshape(-1, draws.shape[-1]).double()
    m = flat.mean(0)
    c = flat - m
    cov = c.T @ c / (flat.shape[0] - 1)
    d = torch.clamp(torch.diagonal(cov).max(), min=1e-20)
    return m, cov + ridge * d * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)


class WhiteMap:
    """x = m + L z (and back) for the moments (m, cov)."""

    def __init__(self, mean, cov):
        self.m = mean.double()
        self.chol = torch.linalg.cholesky(cov.double())

    def to_x(self, z):
        return self.m.to(z.dtype) + z @ self.chol.T.to(z.dtype)
