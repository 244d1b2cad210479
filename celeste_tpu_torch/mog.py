"""2-D Gaussian mixtures on tensors — the L0 math core.

Counterpart of ``celeste_tpu/mog.py``.  ``MoG2D`` is a small class holding
three tensors that may carry leading batch dimensions as long as they
broadcast:

- ``w``   — component weights [..., K];
- ``mu``  — component means [..., K, 2], pixel coordinates (x, y);
- ``cov`` — component covariances [..., K, 2, 2], pixel^2.

2x2 algebra is written elementwise, as in the JAX package, rather than
with ``@``: it keeps the float32 arithmetic identical across devices and
off any TF32 matmul path.
"""

from __future__ import annotations

import torch

_LOG_2PI = 1.8378770664093453


class MoG2D:
    """A mixture of K bivariate Gaussians."""

    def __init__(self, w, mu, cov):
        self.w = w
        self.mu = mu
        self.cov = cov

    def __repr__(self):  # pragma: no cover
        return f"MoG2D(K={self.w.shape[-1]}, w={self.w}, mu={self.mu}, cov={self.cov})"

    @property
    def n_components(self) -> int:
        return self.w.shape[-1]

    def shift(self, delta) -> "MoG2D":
        """Translate all components by ``delta`` ([..., 2])."""
        return MoG2D(self.w, self.mu + delta[..., None, :], self.cov)

    def scale_weights(self, s) -> "MoG2D":
        return MoG2D(self.w * s, self.mu, self.cov)

    def to(self, device) -> "MoG2D":
        return MoG2D(self.w.to(device), self.mu.to(device), self.cov.to(device))


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def precision_form(m: MoG2D):
    """Flatten a MoG to the (amp, mu, prec, half-log-det) tuple the fused
    kernel consumes.

    For each component with covariance ``S``: ``prec = inv(S)`` as its three
    unique entries (a, b, c) with ``inv(S) = [[a, b], [b, c]]``, and
    ``lognorm = -log(2 pi) - 0.5 log det S``, so that the density is
    ``exp(lognorm - 0.5 (a dx^2 + 2 b dx dy + c dy^2))``.

    Returns (amp [..., K], mu [..., K, 2], prec_abc [..., K, 3], lognorm [..., K]).
    """
    s = m.cov
    det = s[..., 0, 0] * s[..., 1, 1] - s[..., 0, 1] * s[..., 1, 0]
    inv_det = 1.0 / det
    a = s[..., 1, 1] * inv_det
    b = -s[..., 0, 1] * inv_det
    c = s[..., 0, 0] * inv_det
    lognorm = -_LOG_2PI - 0.5 * torch.log(det)
    return m.w, m.mu, torch.stack([a, b, c], dim=-1), lognorm


def eval_grid(m: MoG2D, px, py):
    """Mixture density at pixel coordinates ``px``/``py`` (any shape [...]);
    the mixture itself is unbatched.  Dense path: the fused kernel computes
    the same quantity together with the Poisson reduction."""
    amp, mu, prec, lognorm = precision_form(m)
    dx = px[..., None] - mu[..., :, 0]  # [..., K]
    dy = py[..., None] - mu[..., :, 1]
    quad = (prec[..., :, 0] * dx * dx + 2.0 * prec[..., :, 1] * dx * dy
            + prec[..., :, 2] * dy * dy)
    comp = torch.exp(lognorm - 0.5 * quad)
    return torch.sum(amp * comp, dim=-1)


def convolve(f: MoG2D, g: MoG2D) -> MoG2D:
    """Analytic MoG (*) MoG convolution: the mixture over all component
    pairs with weights multiplied, means added, covariances added.  ``f``
    has J components and ``g`` K; the result has J*K, f-major."""
    j = f.w.shape[-1]
    k = g.w.shape[-1]
    w = f.w[..., :, None] * g.w[..., None, :]
    mu = f.mu[..., :, None, :] + g.mu[..., None, :, :]
    cov = f.cov[..., :, None, :, :] + g.cov[..., None, :, :, :]
    return MoG2D(w.reshape(*w.shape[:-2], j * k),
                 mu.reshape(*mu.shape[:-3], j * k, 2),
                 cov.reshape(*cov.shape[:-4], j * k, 2, 2))


def concat(ms) -> MoG2D:
    """Concatenate several mixtures into one (multi-source fields)."""
    return MoG2D(
        torch.cat([m.w for m in ms], dim=-1),
        torch.cat([m.mu for m in ms], dim=-2),
        torch.cat([m.cov for m in ms], dim=-3),
    )


def isotropic(w, mu, var, device="cpu") -> MoG2D:
    """A mixture of isotropic components: ``var`` has shape [K]."""
    w = _f32(w, device)
    var = _f32(var, device)
    eye = torch.eye(2, dtype=torch.float32, device=device)
    cov = var[..., None, None] * eye
    return MoG2D(w, _f32(mu, device), cov)
