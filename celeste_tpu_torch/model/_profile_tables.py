"""Fixed MoG galaxy profile tables (SURVEY.md C4) — GENERATED FILE.

Generated by scripts/fit_profile_tables.py (least-squares fit of concentric
isotropic Gaussian mixtures to the unit-flux, unit-half-light-radius exp and
truncated-deV profiles, following the methodology of Hogg & Lang 2013
arXiv:1210.6563 — constants fitted from scratch, not transcribed).
Amplitudes are component fluxes summing to exactly 1; variances are in units
of the squared half-light radius, normalized so the mixture half-light
radius is exactly 1.  Validated by tests/test_profiles.py.

Fit quality at generation time:
  exp: total_flux=1.000000 r_half=1.000000 max_rel_err=0.0101
  deV: total_flux=1.000000 r_half=1.000000 max_rel_err=0.0461
"""

import numpy as np

EXP_AMPS = np.array([
    4.3635019655e-04,
    1.4149781596e-02,
    1.2164806790e-01,
    3.7198462049e-01,
    3.8578765478e-01,
    1.0599352503e-01])
EXP_VARS = np.array([
    1.6485434678e-03,
    2.3805578318e-02,
    1.4012272385e-01,
    5.0960004218e-01,
    1.3564803662e+00,
    3.1141414836e+00])

DEV_AMPS = np.array([
    4.8918918645e-06,
    8.6803690414e-05,
    8.7615361658e-04,
    5.4456461746e-03,
    2.3038685376e-02,
    7.0456738900e-02,
    1.5576463776e-01,
    2.4069775295e-01,
    2.6317985876e-01,
    2.4044883088e-01])
DEV_VARS = np.array([
    6.1850514895e-08,
    1.3408310900e-06,
    1.9490835418e-05,
    2.0257827115e-04,
    1.6433382253e-03,
    1.1318278571e-02,
    6.9595046765e-02,
    3.8630571049e-01,
    1.9570126210e+00,
    1.1329188405e+01])
