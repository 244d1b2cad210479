"""Crowded fields and the multi-device layer (counterpart of
``celeste_tpu/parallel``): the block-sparse tile maps, the single-device
joint posteriors, and their scaling over a mesh of ranks
(``torch.distributed``) two ways:

- ``chains``: the chain ensemble split over ranks, each advancing its own
  chains; only pooled statistics and diagnostics communicate;
- ``sources``: the source catalog split over ranks, the partial lambdas
  summed before the Poisson log.

and a third way for tempering (``pt_sharded``): the temperature ladder
split over ``temps``, the swap sweep's log densities all-reduced and the
edge replicas exchanged with ``ring_shift``.

Every collective goes through ``collectives.py``; the CPU tests run the
same code on gloo ranks.
"""

from celeste_tpu_torch.parallel.mesh import (  # noqa: F401
    chain_mesh,
    chain_sharding,
    launch,
    make_mesh,
    process_group,
)
from celeste_tpu_torch.parallel.ensemble import (  # noqa: F401
    ChainShard,
    ensemble_diagnostics,
    run_sharded_chees,
    run_sharded_ensemble,
    shard_chains,
)
from celeste_tpu_torch.parallel.crowded import (  # noqa: F401
    CrowdedScene,
    crowded_rect_logprior,
    make_crowded_logdensity,
    make_tiled_crowded_logdensity,
    scene_field_planes,
    sharded_crowded_loglik,
    sharded_tiled_crowded_loglik,
)
from celeste_tpu_torch.parallel import collectives  # noqa: F401
from celeste_tpu_torch.parallel.tiles import build_block_tile_map, build_tile_map  # noqa: F401
from celeste_tpu_torch.parallel.pt_sharded import (  # noqa: F401
    LadderShard,
    sharded_pt_init,
    sharded_pt_kernel,
)
