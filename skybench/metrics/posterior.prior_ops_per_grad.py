"""Device kernels and copies put down to the program's
``celeste.posterior.prior`` span (the priors and log-Jacobians of every
source, their backward by sequence number; ``skybench.spans``) in a traced
window, over the value-and-gradient evaluations the window computed."""

from skybench import spans


def read(rec):
    return spans.per_grad_ops(rec, "posterior.prior")
