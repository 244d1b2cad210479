"""Hand-written Hopper kernels and their wrappers (counterpart of
``celeste_tpu/kernels``).  The CUDA sources live in ``csrc/`` and are built
at first launch; importing this package builds nothing."""

from celeste_tpu_torch.kernels.mog_field import (  # noqa: F401
    batched_stamp_loglik,
    mixed_field_planes,
    mog_field_loglik,
    mog_field_render,
    stamp_pixel_data,
)
from celeste_tpu_torch.kernels.mog_field_sep import (  # noqa: F401
    mog_field_loglik_isotropic,
    psf_is_isotropic,
    stamp_pixel_data_2d,
    star_planes_isotropic,
)
from celeste_tpu_torch.kernels.tiled_field import (  # noqa: F401
    TiledStampData,
    tiled_field_loglik,
    tiled_field_render,
    tiled_field_render_explicit,
)
