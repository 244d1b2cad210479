"""MAP fitting for initialization (counterpart of
``celeste_tpu/inference/map_fit.py``).

Gradient ascent by Adam on the same differentiable log posterior the
samplers use, batch-major: every row of an [N, D] batch of starts is its
own fit, so multi-restart initialization (or one fit per candidate) is one
log-density call per step.  Adam is written out, exactly optax's
``adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0); it is elementwise,
so rows stay independent.

Also provides ``detect_peaks``: a matched-filter detection on the counts
image to produce starting positions when no catalog seed exists (NumPy,
copied from the JAX package, so both find the same peaks bitwise).
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.inference.hmc import value_and_grad

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def map_fit(logdensity_fn, x0, n_steps: int = 300, learning_rate: float = 0.05):
    """Adam ascent on the batched ``logdensity_fn`` ([N, D] -> [N]) from
    ``x0`` [N, D].  Returns (x_map [N, D], logp trace [n_steps, N]); the
    trace holds each step's log density before its update, as JAX's scan.
    A coordinate whose gradient is exactly 0 at every step stays where it
    started."""
    x = x0.detach().clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    trace = []
    for t in range(1, n_steps + 1):
        logp, grad = value_and_grad(logdensity_fn, x)
        trace.append(logp)
        g = -grad
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        m_hat = m / (1.0 - ADAM_B1 ** t)
        v_hat = v / (1.0 - ADAM_B2 ** t)
        x = x - learning_rate * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    if not trace:
        return x, x.new_empty(0, x.shape[0])
    return x, torch.stack(trace)


def map_fit_batch(logdensity_fn, x0_batch, n_steps: int = 300, learning_rate: float = 0.05):
    """Multi-restart MAP: [N, D] starts of one problem -> (best point [D],
    its log density, every fit [N, D], every final log density [N])."""
    xs, _ = map_fit(logdensity_fn, x0_batch, n_steps, learning_rate)
    with torch.no_grad():
        final = logdensity_fn(xs)
    best = int(torch.argmax(final))
    return xs[best], final[best], xs, final


def _host(t):
    """A NumPy float64 copy of a tensor (any device) or array."""
    if torch.is_tensor(t):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def detect_peaks(stamp, n_peaks: int = 4, min_separation: int | None = None):
    """Host-side matched-filter peak detection on a Stamp's counts (the
    detection step the reference outsources to the SDSS photoObj catalog).

    Proper matched-filter SNR: numerator = k * (counts - sky) (Gaussian k
    at the PSF core width), variance = (k^2) * var with var = counts-noise
    variance ~ max(sky, counts).  Peaks greedily selected with an exclusion
    radius defaulting to ~3 sigma of the smoothing kernel.  Returns
    ([n_peaks, 2] pixel (x, y), SNR per peak).  NumPy; runs once per stamp.
    """
    counts = _host(stamp.counts)
    sky = _host(stamp.sky)
    resid = counts - sky
    # Poisson variance ~ the larger of sky and observed counts: using sky
    # alone would overstate SNR by ~sqrt(counts/sky) on and around bright
    # sources (phantom detections in the CLEAN residual loop)
    var = np.maximum(np.maximum(sky, counts), 1.0)
    var0 = float(_host(stamp.psf.cov)[0, 0, 0])
    sig = max(np.sqrt(var0), 0.8)
    if min_separation is None:
        min_separation = max(3, int(round(3 * sig)))
    r = int(3 * sig) + 1
    xk = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (xk / sig) ** 2)
    k /= k.sum()

    def sep_conv(img, kern):
        out = np.apply_along_axis(lambda m: np.convolve(m, kern, mode="same"), 0, img)
        return np.apply_along_axis(lambda m: np.convolve(m, kern, mode="same"), 1, out)

    num = sep_conv(resid, k)
    den = np.sqrt(np.maximum(sep_conv(var, k * k), 1e-9))
    snr = num / den

    peaks, snrs = [], []
    work = snr.copy()
    h, w = work.shape
    for _ in range(n_peaks):
        ij = np.unravel_index(np.argmax(work), work.shape)
        if not np.isfinite(work[ij]):
            break
        peaks.append((float(ij[1]), float(ij[0])))  # (x, y)
        snrs.append(float(work[ij]))
        y0, y1 = max(0, ij[0] - min_separation), min(h, ij[0] + min_separation + 1)
        x0, x1 = max(0, ij[1] - min_separation), min(w, ij[1] + min_separation + 1)
        work[y0:y1, x0:x1] = -np.inf
    return np.asarray(peaks), np.asarray(snrs)
