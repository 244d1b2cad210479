"""Pure-NumPy oracle forward model (copied from ``celeste_tpu/oracle``):
the simulator behind ``data/synthetic.py`` and an independent reference for
the tests."""

from celeste_tpu_torch.oracle.forward import (  # noqa: F401
    oracle_star_lambda,
    oracle_galaxy_lambda,
    oracle_poisson_loglik,
    oracle_scene_lambda,
)
