"""The posterior's mean and standard deviation of each parameter, worked
out by the reference alone: the mode of the dense float64 posterior by
Newton's method from the configuration's true state, the Laplace
covariance there, and importance sampling from a Gaussian mixture around
the mode that corrects the Laplace moments for the posterior's departure
from a Gaussian.

The proposal draws in antithetic pairs (mode +- offset) from the mixture
0.9 N(mode, 1.1 S) + 0.1 N(mode, 4 S), S the Laplace covariance, whose
tails are heavier than the posterior's.  Each moment is the
self-normalised weighted moment of the offsets less the same moment
unweighted minus its known value under the proposal (a control variate):
where the weights are all about 1, their noise cancels.
"""

from __future__ import annotations

import math

import torch

MIX = ((0.9, 1.1), (0.1, 4.0))          # (share, covariance scale) of the proposal


def hessian(post, x, h: float = 1e-5):
    """d^2 log p / dx^2 [D, D] at x [D] (float64), by central differences
    of the analytic gradient, symmetrised."""
    d = x.shape[0]
    eye = torch.eye(d, dtype=torch.float64, device=x.device) * h
    _, g = post.value_and_grad(torch.cat([x[None] + eye, x[None] - eye]))
    hess = (g[:d] - g[d:]) / (2.0 * h)
    return 0.5 * (hess + hess.T)


def find_mode(post, x0, max_iter: int = 50, tol: float = 1e-12):
    """(mode [D], Laplace covariance [D, D], Newton iterations) of the
    posterior, from x0 [D]: damped Newton steps, each halved until the log
    density rises, until the Newton decrement falls under ``tol``."""
    x = torch.as_tensor(x0, dtype=torch.float64, device=post.device).clone()
    for it in range(1, max_iter + 1):
        lp, g = post.value_and_grad(x[None])
        neg_h = -hessian(post, x)
        evals, evecs = torch.linalg.eigh(neg_h)
        evals = torch.clamp(evals, min=1e-8 * float(evals.abs().max()))
        step = evecs @ ((evecs.T @ g[0]) / evals)
        decrement = float(g[0] @ step)
        if decrement < tol:
            break
        t = 1.0
        while t > 1e-6:
            lp_new, _ = post.value_and_grad((x + t * step)[None])
            if float(lp_new[0]) > float(lp[0]) - 1e-9:
                break
            t *= 0.5
        x = x + t * step
    cov = torch.linalg.inv(-hessian(post, x))
    return x, 0.5 * (cov + cov.T), it


def _log_q(off_white, d: int):
    """log density of the proposal at offsets whose whitened squared norm is
    ``off_white`` [n], up to the Laplace covariance's determinant."""
    parts = [math.log(w) - 0.5 * d * math.log(2.0 * math.pi * s) - 0.5 * off_white / s
             for w, s in MIX]
    return torch.logsumexp(torch.stack(parts), dim=0)


def importance_moments(post, mode, cov, n: int, gen, block: int = 8192):
    """(mean [D], sd [D], the weights' effective share) of the posterior from
    ``n`` proposal draws (``n`` even), made with ``gen`` on the posterior's
    device, evaluated in blocks of ``block`` states."""
    d = mode.shape[0]
    chol = torch.linalg.cholesky(cov)
    q_var = sum(w * s for w, s in MIX) * torch.diagonal(cov)
    logw, g1, g2 = [], [], []
    for start in range(0, n // 2, block // 2):
        m = min(block // 2, n // 2 - start)
        comp = torch.rand(m, generator=gen, device=mode.device, dtype=torch.float64) < MIX[0][0]
        scale = torch.where(comp, math.sqrt(MIX[0][1]), math.sqrt(MIX[1][1]))
        u = torch.randn(m, d, generator=gen, device=mode.device, dtype=torch.float64)
        u = u * scale[:, None]
        off = torch.cat([u, -u]) @ chol.T
        white = torch.cat([u, -u]).square().sum(1)
        lp = post.logp_blocks(mode[None] + off)
        logw.append(lp - _log_q(white, d))
        g1.append(off)
        g2.append(off.square())
    logw, g1, g2 = torch.cat(logw), torch.cat(g1), torch.cat(g2)
    w = torch.exp(logw - logw.max())
    wbar = w / w.mean()
    e1 = (wbar[:, None] * g1).mean(0) - g1.mean(0)
    e2 = (wbar[:, None] * g2).mean(0) - (g2.mean(0) - q_var)
    share = float(w.sum() ** 2 / (w.numel() * (w * w).sum()))
    return mode + e1, torch.sqrt(torch.clamp(e2 - e1 * e1, min=0.0)), share
