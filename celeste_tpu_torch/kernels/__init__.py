"""Hand-written Hopper kernels and their wrappers (counterpart of
``celeste_tpu/kernels``).  The CUDA sources live in ``csrc/`` and are built
at first launch; importing this package builds nothing."""

from celeste_tpu_torch.kernels.mog_field import (  # noqa: F401
    batched_stamp_loglik,
    mog_field_loglik,
    stamp_pixel_data,
)
