"""Split-R-hat and the multi-chain effective sample size (FFT
autocorrelation, Geyer's initial positive sequence), frozen from the
program's ``inference/diagnostics.py`` so that a change there does not
move the benchmark's ESS."""

from __future__ import annotations

import torch


def split_rhat(samples):
    """[n_chains, n_steps, ...] -> R-hat per parameter, each chain split
    in half."""
    n = samples.shape[1]
    half = n // 2
    s = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    chain_mean = torch.mean(s, dim=1)
    chain_var = torch.var(s, dim=1, correction=1)
    b = half * torch.var(chain_mean, dim=0, correction=1)
    w = torch.mean(chain_var, dim=0)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _autocov_fft(x):
    n = x.shape[-1]
    x = x - torch.mean(x, dim=-1, keepdim=True)
    nfft = _next_pow2(2 * n)
    f = torch.fft.rfft(x, n=nfft, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-1)[..., :n]
    return acov / n


def ess(samples):
    """[n_chains, n_steps] or [n_chains, n_steps, D] -> ESS, a scalar or
    [D], the chains combined, truncated at the first non-positive pair."""
    if samples.dim() == 2:
        samples = samples[..., None]
    c, n, d = samples.shape
    acov = _autocov_fft(torch.movedim(samples, 1, -1))
    chain_var = acov[..., 0] * n / (n - 1.0)
    w = torch.mean(chain_var, dim=0)
    mean_acov = torch.mean(acov, dim=0)
    chain_means = torch.mean(samples, dim=1)
    b_over_n = (torch.var(chain_means, dim=0, correction=1) if c > 1
                else torch.zeros(d, dtype=samples.dtype, device=samples.device))
    var_plus = w * (n - 1.0) / n + b_over_n
    rho = 1.0 - (w - mean_acov.T) / var_plus
    n_pairs = (n - 1) // 2
    pair = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    keep = torch.cumprod((pair > 0.0).to(rho.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(pair * keep, dim=0)
    out = c * n / torch.clamp(tau, min=1e-3)
    return out[0] if d == 1 else out
