"""What the ranks of ``tests/test_torch_chees_groups.py`` run: spawned
processes (``celeste_tpu_torch.parallel.mesh.launch``) that import this
module by name, so it imports only the port and NumPy.

``field_run`` runs the field pipeline on tests/test_field.py's two-group
frame (a blended star pair and an isolated star, 64x64) at a cut of that
file's small sampling settings, with the fit groups sharded over a
``groups`` mesh of the whole world when ``sharded``, and returns the
samples and catalog as NumPy.  Run without a process group it is the
single-device reference.
"""

import numpy as np

from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

ASU = 1.0 / 3600.0
COSD = np.cos(np.deg2rad(10.0))
PRIORS = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
# tests/test_field.py's _small_cfg, its sampling cut in steps
SMALL = dict(sample=True, seed=4, n_chains=6, probe_warmup=8, probe_steps=6, n_warmup=8,
             n_steps=10, max_leapfrog=12, map_steps=60, type_switch=False, group_cut=32,
             group_margin_px=8)


def two_group_frame(device="cpu"):
    srcs = [
        star_source(u=(30.0 - 8 * ASU / COSD, 10.0 - 8 * ASU), flux_r=55.0),
        star_source(u=(30.0 + 7 * ASU / COSD, 10.0 + 7 * ASU), flux_r=45.0),
        star_source(u=(30.0 + (7 + 3.0) * ASU / COSD, 10.0 + 7 * ASU), flux_r=35.0),
    ]
    return make_synthetic_stamp(srcs, shape=(64, 64), bands=(2,), seed=23, device=device), srcs


def field_run(sharded: bool, **over):
    mesh = None
    if sharded:
        import torch.distributed as dist

        from celeste_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"groups": dist.get_world_size()}, device_type="cpu")
    scene, _ = two_group_frame()
    cat, art = run_field_pipeline(scene.stamps[0], band=0, n_bands=1,
                                  cfg=FieldConfig(**(SMALL | over)), priors=PRIORS, mesh=mesh)
    return {"samples": art["samples"], "n_groups": art["n_groups"],
            "du_mean": np.stack([e.du_mean for e in cat]),
            "flux_mean": np.stack([e.flux_mean for e in cat]),
            "kinds": [e.kind for e in cat]}
