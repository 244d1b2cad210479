"""Convergence diagnostics on tensors (counterpart of
``celeste_tpu/inference/diagnostics.py``): split-R-hat, effective sample
size by FFT autocorrelation (Geyer initial positive sequence), summaries."""

from __future__ import annotations

import torch


def split_rhat(samples):
    """Split-chain potential scale reduction factor.  ``samples``:
    [n_chains, n_steps, ...]; each chain is split in half.  Returns R-hat
    per parameter dimension."""
    c, n = samples.shape[0], samples.shape[1]
    half = n // 2
    s = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    chain_mean = torch.mean(s, dim=1)                   # [m, ...]
    chain_var = torch.var(s, dim=1, correction=1)       # [m, ...]
    b = half * torch.var(chain_mean, dim=0, correction=1)   # between
    w = torch.mean(chain_var, dim=0)                    # within
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _autocov_fft(x):
    """Autocovariance of [..., n] series via FFT."""
    n = x.shape[-1]
    x = x - torch.mean(x, dim=-1, keepdim=True)
    nfft = _next_pow2(2 * n)
    f = torch.fft.rfft(x, n=nfft, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-1)[..., :n]
    return acov / n


def ess(samples):
    """Effective sample size combining chains (multi-chain autocorrelation,
    truncated at the first non-positive pair sum).  ``samples``:
    [n_chains, n_steps] or [n_chains, n_steps, D] -> scalar or [D]."""
    if samples.dim() == 2:
        samples = samples[..., None]
    c, n, d = samples.shape
    acov = _autocov_fft(torch.movedim(samples, 1, -1))     # [c, d, n]
    chain_var = acov[..., 0] * n / (n - 1.0)
    w = torch.mean(chain_var, dim=0)                        # [d]
    mean_acov = torch.mean(acov, dim=0)                     # [d, n]
    chain_means = torch.mean(samples, dim=1)                # [c, d]
    b_over_n = (torch.var(chain_means, dim=0, correction=1) if c > 1
                else torch.zeros(d, dtype=samples.dtype, device=samples.device))
    var_plus = w * (n - 1.0) / n + b_over_n
    rho = 1.0 - (w - mean_acov.T) / var_plus                # [n, d]
    # pair sums rho_{2t} + rho_{2t+1}, truncated at the first non-positive pair
    n_pairs = (n - 1) // 2
    pair = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)   # [P, d]
    keep = torch.cumprod((pair > 0.0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(pair * keep, dim=0)
    out = c * n / torch.clamp(tau, min=1e-3)
    return out[0] if d == 1 else out


def summarize(samples):
    """Per-dimension posterior summary of [n_chains, n_steps, D]."""
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "mean": torch.mean(flat, dim=0),
        "std": torch.std(flat, dim=0, correction=0),
        "rhat": split_rhat(samples),
        "ess": ess(samples),
    }
