"""The crowded field's prior: every source's prior and log |det J| of a
joint state, summed per chain, as ``parallel.crowded._crowded_logprior``
gives it.

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
  uploaded once, when the object is built, so a call copies nothing from
  the host and synchronises nothing.  A build or launch failure raises.
- CPU tensors take the plain version, ``_crowded_logprior``, differentiated
  by autograd.

Either way the call sits in the ``posterior.prior`` span.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from celeste_tpu_torch.utils.profiling import span

_SOURCES = ("scene_prior.cu",)
# every product and sum rounded on its own, as the plain version's separate
# elementwise operations round them
_FLAGS = ("-fmad=false",)
MAX_BANDS = 8                    # csrc/scene_prior.cu kMaxBands


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scene_prior_fwd.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.scene_prior_fwd.restype = i
    lib.scene_prior_bwd.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.scene_prior_bwd.restype = i
    lib.scene_prior_error_string.argtypes = [i]
    lib.scene_prior_error_string.restype = ctypes.c_char_p


def _lib():
    from celeste_tpu_torch.kernels._build import load_library

    return load_library("scene_prior", _SOURCES, _declare, _FLAGS)


def build_kernels():
    """Build and load the CUDA library now (it is otherwise built at the
    first launch).  Returns the path of the shared library."""
    return Path(_lib()._name)


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
        raise ValueError("a ColorGMM colour prior has no kernel; it keeps _crowded_logprior")
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
    blocks, _ = scene.block_slices()
    table = np.asarray([[int(kind == "galaxy"), off] for off, _, kind in blocks],
                       np.int32).reshape(-1)
    # FluxPrior.logpdf's clamp of the reference slot, indexed as torch indexes
    ref = range(nb)[min(flux.ref_band, nb - 1)]
    return floats, table, ref


class ScenePrior:
    """``prior(vecs [B, D_total]) -> [B]``: the sum over the scene's sources
    of prior + log |det J|."""

    def __init__(self, scene, priors, device):
        self.scene, self.priors = scene, priors
        consts, table, self.ref_band = pack_constants(scene, priors)
        self.d_total = scene.dim
        self.consts = self.table = None
        device = torch.device(device)
        if device.type == "cuda":
            if scene.n_bands > MAX_BANDS:
                raise ValueError(f"the prior kernels take at most {MAX_BANDS} bands")
            self.consts = torch.as_tensor(consts, device=device)
            self.table = torch.as_tensor(table, device=device)

    def plain(self, vecs):
        from celeste_tpu_torch.parallel.crowded import _crowded_logprior

        return _crowded_logprior(self.scene, self.priors, vecs)

    def __call__(self, vecs):
        if vecs.device.type == "cpu":
            return self.plain(vecs)
        if vecs.device.type != "cuda":
            raise ValueError(f"the scene prior has no implementation on {vecs.device}")
        return self.launch(vecs)

    def launch(self, vecs):
        """The kernel pair under autograd, in the ``posterior.prior`` span."""
        with span("posterior.prior"):
            return _ScenePriorKernel.apply(self, vecs)

    def check(self, vecs):
        """Raise unless ``vecs`` is a float32 [B, D_total] CUDA tensor on the
        device of the constants."""
        if self.consts is None or vecs.device != self.consts.device:
            raise ValueError(f"states on {vecs.device}, the prior's constants on "
                             f"{None if self.consts is None else self.consts.device}")
        if vecs.dtype != torch.float32 or vecs.dim() != 2 or vecs.shape[1] != self.d_total:
            raise ValueError(f"states must be float32 [B, {self.d_total}], got {vecs.dtype} "
                             f"{tuple(vecs.shape)}")
        if not vecs.is_contiguous():
            raise ValueError("states are not contiguous")

    def _dims(self, b):
        return b, self.d_total, self.scene.n_sources, self.scene.n_bands, self.ref_band


def _launch(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.scene_prior_error_string(err).decode()} ({err})")


def scene_prior_fwd_cuda(prep: ScenePrior, vecs):
    """Launch the forward: prior + log |det J| [B] of the states ``vecs``."""
    prep.check(vecs)
    b = vecs.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=vecs.device)
    if b:
        with torch.cuda.device(vecs.device):
            stream = torch.cuda.current_stream(vecs.device).cuda_stream
            _launch("scene_prior_fwd", vecs.data_ptr(), prep.consts.data_ptr(),
                    prep.table.data_ptr(), out.data_ptr(), *prep._dims(b), stream)
    scene_prior_fwd_cuda.launches += 1
    return out


scene_prior_fwd_cuda.launches = 0


def scene_prior_bwd_cuda(prep: ScenePrior, vecs, g):
    """Launch the backward: the gradient [B, D_total] of sum(g * prior) at
    the states ``vecs`` from the per-chain cotangent ``g`` [B]."""
    prep.check(vecs)
    b = vecs.shape[0]
    g = g.contiguous()
    if g.dtype != torch.float32 or tuple(g.shape) != (b,) or g.device != vecs.device:
        raise ValueError(f"the cotangent is {g.dtype} {tuple(g.shape)} on {g.device}, "
                         f"expected float32 [{b}] on {vecs.device}")
    grad = torch.empty_like(vecs)
    if b:
        with torch.cuda.device(vecs.device):
            stream = torch.cuda.current_stream(vecs.device).cuda_stream
            _launch("scene_prior_bwd", vecs.data_ptr(), g.data_ptr(), prep.consts.data_ptr(),
                    prep.table.data_ptr(), grad.data_ptr(), *prep._dims(b), stream)
    scene_prior_bwd_cuda.launches += 1
    return grad


scene_prior_bwd_cuda.launches = 0


class _ScenePriorKernel(torch.autograd.Function):
    """The forward launch, with the backward launch as its gradient; only
    the states are saved."""

    @staticmethod
    def forward(ctx, prep, vecs):
        vecs = vecs.contiguous()
        ctx.save_for_backward(vecs)
        ctx.prep = prep
        return scene_prior_fwd_cuda(prep, vecs)

    @staticmethod
    def backward(ctx, g):
        (vecs,) = ctx.saved_tensors
        return None, scene_prior_bwd_cuda(ctx.prep, vecs, g)
