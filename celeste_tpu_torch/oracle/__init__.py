"""Pure-NumPy oracles (copied from ``celeste_tpu/oracle``): the forward
model behind ``data/synthetic.py``, the MH and slice samplers, and the
photo-z posterior with its slice-within-tempering sampler; independent
references for the tests."""

from celeste_tpu_torch.oracle.forward import (  # noqa: F401
    oracle_star_lambda,
    oracle_galaxy_lambda,
    oracle_poisson_loglik,
    oracle_scene_lambda,
)
from celeste_tpu_torch.oracle.samplers import oracle_mh, oracle_slice_sample  # noqa: F401
