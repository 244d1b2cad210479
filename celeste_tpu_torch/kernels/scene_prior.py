"""The crowded field's prior: every source's prior and log |det J| of a
joint state, summed per chain, as the plain :func:`scene_logprior` gives it
(``parallel.crowded._crowded_logprior`` is it in the ``posterior.prior``
span).

:class:`ScenePrior` is built once per log density
(``parallel.crowded.make_tiled_crowded_logdensity``) for priors with
Gaussian colours; a ``ColorGMM`` colour prior has no kernel and keeps the
plain graph.  Dispatch follows the states' device, with no switch and no
fallback:

- CUDA tensors launch the hand-written pair of ``csrc/scene_prior.cu``:
  ``scene_prior_fwd_cuda`` computes every chain's sum over the sources in
  one launch, and under autograd ``scene_prior_bwd_cuda`` turns the
  per-chain cotangent into the states' gradient in one launch.  The prior's
  constants and the per-source table (kind, offset in the state) are
  uploaded once, when the object is built (``kernels/_scene.py``).  A build
  or launch failure raises.
- CPU tensors take the plain version, :func:`scene_logprior`,
  differentiated by autograd.

The caller opens the ``posterior.prior`` span around the call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from celeste_tpu_torch.kernels._build import Library, check_tensor
from celeste_tpu_torch.kernels._scene import SceneFunction, ScenePair, source_table

# built with every product and sum rounded on its own, as the plain
# version's separate elementwise operations round them
LIBRARY = Library("scene_prior", ("scene_prior.cu",), {
    "scene_prior_fwd": "p" * 4 + "i" * 5 + "p",
    "scene_prior_bwd": "p" * 5 + "i" * 5 + "p",
}, flags=("-fmad=false",))
build_kernels = LIBRARY.build
launch_counts, reset_launch_counts = LIBRARY.launch_counts, LIBRARY.reset_launch_counts


def _beta_log_norm(a, b):
    """``model/priors.py::_beta_logpdf``'s normaliser, in float64."""
    return math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)


def _reciprocal(x):
    """The float32 reciprocal by which PyTorch's CUDA division multiplies
    where the divisor is a Python float."""
    return np.float32(1.0) / np.float32(x)


def pack_constants(scene, priors):
    """The kernels' constants: (float32 array, int32 table, reference band),
    in the layout ``csrc/scene_prior.cu`` describes.  The floats are the
    fixed scalars (rounded from float64 where the plain graph subtracts a
    Python float) and the n_bands - 1 colour means, standard deviations and
    their logarithms; the table holds each source's kind (1 galaxy) and
    offset in the state.  Raises for a ``ColorGMM`` colour prior and for a
    prior with fewer colours than the scene has."""
    flux, pos, shape = priors.flux, priors.position, priors.shape
    if flux.color_gmm is not None:
        raise ValueError("a ColorGMM colour prior has no kernel; it keeps scene_logprior")
    nb = scene.n_bands
    if min(len(flux.color_mean), len(flux.color_std)) < nb - 1:
        raise ValueError(f"{len(flux.color_mean)} colour means and {len(flux.color_std)} "
                         f"standard deviations for {nb} bands")
    fixed = [flux.log_ref_mean, _reciprocal(flux.log_ref_std), math.log(flux.log_ref_std),
             pos.halfwidth_arcsec, _reciprocal(pos.rolloff),
             shape.theta_a - 1.0, shape.theta_b - 1.0,
             _beta_log_norm(shape.theta_a, shape.theta_b),
             shape.log_sigma_mean, _reciprocal(shape.log_sigma_std),
             math.log(shape.log_sigma_std),
             shape.ab_a - 1.0, shape.ab_b - 1.0, _beta_log_norm(shape.ab_a, shape.ab_b),
             math.log(math.pi)]
    colour_std = np.asarray(flux.color_std[:nb - 1], np.float32)
    floats = np.concatenate([np.asarray(fixed, np.float32),
                             np.asarray(flux.color_mean[:nb - 1], np.float32),
                             colour_std, np.log(colour_std)]).astype(np.float32)
    # FluxPrior.logpdf's clamp of the reference slot, indexed as torch indexes
    ref = range(nb)[min(flux.ref_band, nb - 1)]
    return floats, source_table(scene), ref


def scene_logprior(scene, priors, vecs):
    """The plain version: prior + log |det J| [B] of every source of the
    joint states ``vecs``, summed per chain, differentiable by autograd."""
    from celeste_tpu_torch.model.params import GalaxyParams, StarParams

    lp = 0.0
    blocks, _ = scene.block_slices()
    for (off, d, kind), params in zip(blocks, scene.unpack(vecs)):
        v = vecs[..., off:off + d]
        if kind == "star":
            lp = lp + priors.star_logpdf(params) + StarParams.log_det_jacobian(v, scene.n_bands)
        else:
            lp = (lp + priors.galaxy_logpdf(params)
                  + GalaxyParams.log_det_jacobian(v, scene.n_bands))
    return lp


class ScenePrior(ScenePair):
    """``prior(vecs [B, D_total]) -> [B]``: the sum over the scene's sources
    of prior + log |det J|."""

    def __init__(self, scene, priors, device):
        self.priors = priors
        self._packed = pack_constants(scene, priors)
        self.ref_band = self._packed[2]
        super().__init__(scene, device)

    def pack(self):
        return self._packed[:2]

    def plain(self, vecs):
        return scene_logprior(self.scene, self.priors, vecs)

    def launch(self, vecs):
        return _ScenePriorKernel.apply(self, vecs)

    def fwd(self, vecs):
        return scene_prior_fwd_cuda(self, vecs)

    def bwd(self, vecs, grads):
        return scene_prior_bwd_cuda(self, vecs, grads[0])

    def _dims(self, b):
        return b, self.d_total, self.scene.n_sources, self.scene.n_bands, self.ref_band


def scene_prior_fwd_cuda(prep: ScenePrior, vecs):
    """Launch the forward: prior + log |det J| [B] of the states ``vecs``."""
    prep.check(vecs)
    b = vecs.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=vecs.device)
    if b:
        LIBRARY.launch("scene_prior_fwd", vecs.device, vecs.data_ptr(), prep.consts.data_ptr(),
                       prep.table.data_ptr(), out.data_ptr(), *prep._dims(b))
    return out


def scene_prior_bwd_cuda(prep: ScenePrior, vecs, g):
    """Launch the backward: the gradient [B, D_total] of sum(g * prior) at
    the states ``vecs`` from the per-chain cotangent ``g`` [B]."""
    prep.check(vecs)
    b = vecs.shape[0]
    g = g.contiguous()
    check_tensor(g, "the cotangent", (b,), vecs.device)
    grad = torch.empty_like(vecs)
    if b:
        LIBRARY.launch("scene_prior_bwd", vecs.device, vecs.data_ptr(), g.data_ptr(),
                       prep.consts.data_ptr(), prep.table.data_ptr(), grad.data_ptr(),
                       *prep._dims(b))
    return grad


class _ScenePriorKernel(SceneFunction):
    """The prior pair under autograd."""
