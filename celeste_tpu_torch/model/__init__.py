"""Generative model layer: stamps, sources, PSFs, galaxy profiles and the
dense differentiable renderer (counterpart of ``celeste_tpu/model``)."""

from celeste_tpu_torch.model.stamp import Stamp, HostWcs  # noqa: F401
from celeste_tpu_torch.model.params import StarParams, GalaxyParams  # noqa: F401
from celeste_tpu_torch.model.render import (  # noqa: F401
    field_mog,
    expected_image,
    star_unit_mog,
    galaxy_unit_mog,
)
