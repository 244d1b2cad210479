"""Likelihood layer: per-pixel Poisson log-likelihood."""

from celeste_tpu_torch.likelihood.poisson import (  # noqa: F401
    poisson_loglik,
    stamp_loglik,
    multi_stamp_loglik,
)
