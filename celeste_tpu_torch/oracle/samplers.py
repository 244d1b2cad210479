"""Oracle samplers (copied from ``celeste_tpu/oracle/samplers.py``):
plain-NumPy random-walk Metropolis-Hastings and univariate stepping-out
slice sampling (the reference's gradient-free kernels, reimplemented from
Neal 2003 and Metropolis et al.), an independent reference for the
port's samplers.
"""

from __future__ import annotations

import numpy as np


def oracle_mh(logprob, x0, n_steps, step_scales, rng):
    """Random-walk MH.  Returns (samples [n_steps, D], accept_rate)."""
    x = np.array(x0, dtype=float)
    lp = logprob(x)
    out = np.empty((n_steps, x.size))
    n_acc = 0
    for i in range(n_steps):
        prop = x + rng.normal(size=x.size) * step_scales
        lp_prop = logprob(prop)
        if np.log(rng.uniform()) < lp_prop - lp:
            x, lp = prop, lp_prop
            n_acc += 1
        out[i] = x
    return out, n_acc / n_steps


def oracle_slice_sample(logprob, x0, n_steps, widths, rng, max_stepout=20):
    """Coordinate-wise slice sampling with stepping-out + shrinkage
    (Neal 2003 §4).  Returns samples [n_steps, D]."""
    x = np.array(x0, dtype=float)
    d = x.size
    out = np.empty((n_steps, d))
    for i in range(n_steps):
        for j in range(d):
            log_y = logprob(x) + np.log(rng.uniform())
            # stepping out
            lo = x[j] - widths[j] * rng.uniform()
            hi = lo + widths[j]
            for _ in range(max_stepout):
                xl = x.copy(); xl[j] = lo
                if logprob(xl) <= log_y:
                    break
                lo -= widths[j]
            for _ in range(max_stepout):
                xh = x.copy(); xh[j] = hi
                if logprob(xh) <= log_y:
                    break
                hi += widths[j]
            # shrinkage
            while True:
                prop = lo + rng.uniform() * (hi - lo)
                xp = x.copy(); xp[j] = prop
                if logprob(xp) > log_y:
                    x = xp
                    break
                if prop < x[j]:
                    lo = prop
                else:
                    hi = prop
        out[i] = x
    return out
