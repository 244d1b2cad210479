"""The device's idle time put down to the program's
``celeste.posterior.planes`` span (each gap to the span of the operation
that ends it; ``skybench.spans``) over the traced window's wall."""

from skybench import spans


def read(rec):
    return spans.idle_share(rec, "posterior.planes")
