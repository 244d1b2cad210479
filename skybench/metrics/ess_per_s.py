"""Minimum over the posterior's parameters of the effective sample size of
all the window's draws (every chain pooled, x-space; the frozen estimator
of ``reference.diagnostics``), over the window's seconds."""


def read(rec):
    return rec.min_ess() / rec.window["seconds"]
