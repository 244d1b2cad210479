"""What the ranks of ``tests/test_torch_pt_sharded.py`` run: spawned
processes (``celeste_tpu_torch.parallel.mesh.launch``) that import this
module by name, so it imports only the port and NumPy.  Each function runs
on every rank of a ``temps`` mesh over the whole world and returns plain
data to the test; ``in_device`` gives the same run's single-process
reference with the port's ``pt_kernel`` and ``run_photo_z``.

The ladder is tests/test_collectives.py:187's: a bimodal 2-D target, 8
temperatures from 1 to 0.05, MH with scales 0.4; then the same ladder with
the lockstep slice inner (unit widths, 6 steps), whose loops run as long
as any rank's chain is active.  The photo-z run is
tests/test_collectives.py:296's: the default basis, 64-point filters, a
target at z = 2 with 2% errors, 4 temperatures, ``hmc_adaptive``, 25 steps
after a 15-step warmup, the exact projection.
"""

import numpy as np
import torch
import torch.distributed as dist

from celeste_tpu_torch.inference.tempering import (
    geometric_ladder, mh_at_beta, pt_init, pt_kernel, slice_at_beta,
)
from celeste_tpu_torch.parallel import make_mesh
from celeste_tpu_torch.parallel.pt_sharded import LadderShard, sharded_pt_init, sharded_pt_kernel
from celeste_tpu_torch.quasar import (
    PhotoZConfig, QuasarBasis, project_to_bands, run_photo_z, run_photo_z_sharded,
    sdss_like_filterbank,
)

N_TEMPS, N_STEPS, SLICE_STEPS, SEED = 8, 20, 6, 7
PHOTO_Z = PhotoZConfig(n_temps=4, n_steps=25, n_warmup=5, n_systems=1, inner="hmc_adaptive",
                       pt_warmup_steps=15, flux_grid_n=0)


def bimodal(x):
    return torch.logaddexp(-0.5 * torch.sum((x - 2.0) ** 2, -1) / 0.3,
                           -0.5 * torch.sum((x + 2.0) ** 2, -1) / 0.3)


def _start():
    return torch.as_tensor(np.random.default_rng(0).normal(size=(3, N_TEMPS, 2)),
                           dtype=torch.float32)


def _ladder(kern, state, n_steps=N_STEPS):
    gen = torch.Generator().manual_seed(SEED)
    accepts = []
    with torch.no_grad():
        for _ in range(n_steps):
            state, info = kern(gen, state)
            accepts.append(info.swap_accept.numpy())
    return state.xs.numpy(), state.logps.numpy(), np.stack(accepts)


def _photo_z_target():
    basis, filt = QuasarBasis.default(), sdss_like_filterbank(n_pts=64)
    flux = project_to_bands(basis, filt, torch.full((basis.n_basis,), 1.0 / basis.n_basis), 1.0,
                            2.0).numpy()
    return basis, filt, flux, 0.02 * np.abs(flux) + 1e-4


def in_device():
    """The single-process ladder and photo-z run."""
    betas = geometric_ladder(N_TEMPS, 0.05)
    kern = pt_kernel(bimodal, mh_at_beta(bimodal, torch.full((2,), 0.4)), betas)
    ladder = _ladder(kern, pt_init(_start(), bimodal))
    kern = pt_kernel(bimodal, slice_at_beta(bimodal, torch.ones(2)), betas)
    slice_ladder = _ladder(kern, pt_init(_start(), bimodal), SLICE_STEPS)
    basis, filt, flux, err = _photo_z_target()
    out = run_photo_z(5, basis, filt, flux, err, PHOTO_Z, device="cpu")
    return ladder, out["vec"].numpy(), slice_ladder


def sharded_rank():
    """This rank's replicas of the sharded ladder after N_STEPS steps (xs,
    logps, every step's swap decisions) and the sharded photo-z run's
    cold-chain draws."""
    mesh = make_mesh({"temps": dist.get_world_size()}, "cpu")
    betas = geometric_ladder(N_TEMPS, 0.05)
    inner = mh_at_beta(bimodal, torch.full((2,), 0.4), noise=LadderShard(mesh, "temps", N_TEMPS))
    kern = sharded_pt_kernel(bimodal, inner, betas, mesh, "temps")
    ladder = _ladder(kern, sharded_pt_init(_start(), bimodal, mesh, "temps"))
    inner = slice_at_beta(bimodal, torch.ones(2), noise=LadderShard(mesh, "temps", N_TEMPS))
    kern = sharded_pt_kernel(bimodal, inner, betas, mesh, "temps")
    slice_ladder = _ladder(kern, sharded_pt_init(_start(), bimodal, mesh, "temps"), SLICE_STEPS)
    basis, filt, flux, err = _photo_z_target()
    out = run_photo_z_sharded(5, basis, filt, flux, err, mesh, PHOTO_Z, device="cpu")
    return ladder, out["vec"].numpy(), slice_ladder
