"""Crowded fields: the block-sparse tile maps and the single-device joint
posteriors (counterpart of ``celeste_tpu/parallel``; the mesh, collectives
and source-sharded paths are not yet ported, see ROADMAP.md)."""

from celeste_tpu_torch.parallel.crowded import (  # noqa: F401
    CrowdedScene,
    make_crowded_logdensity,
    make_tiled_crowded_logdensity,
    scene_field_planes,
)
