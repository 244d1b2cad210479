"""Pure-NumPy photo-z oracle (copied from ``celeste_tpu/oracle/photoz.py``;
BASELINE config 4, the reference's ``quasar_infer_photometry``: slice
sampling within parallel tempering over p(z, w, m | band fluxes), Miller et
al. 2015).

Written in the reference's compute style (NumPy ``np.interp`` projection,
Python loops over temperatures and coordinates), an independent reference
for ``quasar.photo_z``.  The target density is exactly
``make_photo_z_logdensity``'s with the exact projection: the same
unconstrained parameterization (zeta -> z via scaled sigmoid, ALR eta ->
simplex w, log_m -> m), the same priors and Jacobians.
"""

from __future__ import annotations

import numpy as np

from celeste_tpu_torch.oracle.samplers import oracle_slice_sample


def oracle_project_to_bands(lam_rest, b, filt_lam, filt_weight, w, m, z):
    """NumPy ``project_to_bands``: band fluxes [n_bands] for basis rows
    ``b`` [K, L] on ``lam_rest`` [L], filter grids ``filt_lam`` [n_bands,
    n_pts] with precomputed integration weights ``filt_weight``
    (= resp * lam * dlam), simplex weights ``w`` [K], scale ``m``,
    redshift ``z``."""
    n_bands, n_pts = filt_lam.shape
    q = (filt_lam / (1.0 + z)).ravel()
    # np.interp(left/right=0) matches the JAX path's out-of-range clamp
    fvals = np.stack([np.interp(q, lam_rest, row, left=0.0, right=0.0)
                      for row in b])                    # [K, n_bands*n_pts]
    fvals = fvals.reshape(b.shape[0], n_bands, n_pts)
    mat = np.einsum("kbp,bp->bk", fvals, filt_weight)   # [n_bands, K]
    return m * (mat @ w)


def oracle_photoz_logprob(vec, lam_rest, b, filt_lam, filt_weight,
                          flux_obs, flux_err, z_max=6.0,
                          log_m_mean=0.0, log_m_std=3.0, eta_std=2.0):
    """Unconstrained log posterior — the same density as
    ``make_photo_z_logdensity`` (priors, Jacobians and all)."""
    k = b.shape[0]
    zeta, eta, log_m = vec[0], vec[1:k], vec[k]
    z = z_max / (1.0 + np.exp(-zeta))
    e = np.exp(np.concatenate([eta, [0.0]])
               - max(np.max(eta), 0.0))                 # stable softmax
    w = e / e.sum()
    m = np.exp(log_m)
    model = oracle_project_to_bands(lam_rest, b, filt_lam, filt_weight,
                                    w, m, z)
    resid = (flux_obs - model) / flux_err
    ll = -0.5 * float(resid @ resid)
    # z flat on (0, z_max): sigmoid log-Jacobian; eta/log_m Gaussian
    ljd_z = -np.logaddexp(0.0, -zeta) - np.logaddexp(0.0, zeta)
    lp_eta = -0.5 * float(eta @ eta) / eta_std**2
    lp_m = -0.5 * ((log_m - log_m_mean) / log_m_std) ** 2
    return ll + ljd_z + lp_eta + lp_m


def geometric_betas(n_temps, beta_min):
    """Reference-style geometric temperature ladder, beta[0] = 1 (cold)."""
    return beta_min ** (np.arange(n_temps) / max(n_temps - 1, 1))


def oracle_photoz_pt(logprob, x0s, betas, n_steps, widths, rng):
    """Slice-within-parallel-tempering: each PT step runs one coordinate
    slice sweep per replica at its tempered density, then attempts
    even/odd neighbor swaps (alternating parity, Metropolis on the
    tempered-density exchange ratio — the rebuild's swap rule).

    Returns (cold-chain samples [n_steps, D], swap_accept_rate).
    """
    n_temps = len(betas)
    xs = [np.array(x, dtype=float) for x in x0s]
    lps = [logprob(x) for x in xs]
    cold = np.empty((n_steps, xs[0].size))
    n_swap, n_att = 0, 0
    for t in range(n_steps):
        for i in range(n_temps):
            beta = betas[i]
            s = oracle_slice_sample(lambda v: beta * logprob(v), xs[i],
                                    1, widths, rng)
            xs[i] = s[-1]
            lps[i] = logprob(xs[i])
        for i in range(t % 2, n_temps - 1, 2):
            n_att += 1
            dlog = (betas[i] - betas[i + 1]) * (lps[i + 1] - lps[i])
            if np.log(rng.uniform()) < dlog:
                xs[i], xs[i + 1] = xs[i + 1], xs[i]
                lps[i], lps[i + 1] = lps[i + 1], lps[i]
                n_swap += 1
        cold[t] = xs[0]
    return cold, n_swap / max(n_att, 1)
