"""Plane preparation of the tiled crowded field: a joint state's six
precision-form planes for every source and band, as the tiled kernels take
them.

:class:`ScenePlanes` is built once per log density
(``parallel.crowded.make_tiled_crowded_logdensity``).  Dispatch follows the
states' device, with no switch and no fallback:

- CUDA tensors launch the hand-written pair of ``csrc/scene_planes.cu``:
  ``scene_planes_fwd_cuda`` writes every band's planes in one launch, and
  under autograd ``scene_planes_bwd_cuda`` turns every band's plane
  cotangents into the states' gradient in one launch.  The band constants
  (PSF, WCS, iota) and the per-source table (kind, offset in the state) are
  uploaded once, when the object is built (``kernels/_scene.py``).  A
  build or launch failure raises.
- CPU tensors take the plain version, ``scene_planes_blocked`` (a scene of
  two kinds) or ``scene_planes_padded`` (one kind) of
  ``kernels/tiled_field.py`` once per band, differentiated by autograd.

The layout follows the scene's kinds: the block-slot layout (every source
N_GAL * K columns wide) for a mixed scene, the source-major layout of one
kind otherwise; the last slot is the zero sentinel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from celeste_tpu_torch.kernels._build import Library, check_tensor
from celeste_tpu_torch.kernels._scene import MAX_BANDS, SceneFunction, ScenePair, source_table

# built with every product and sum rounded on its own, as the plain
# version's separate elementwise operations round them
LIBRARY = Library("scene_planes", ("scene_planes.cu",), {
    "scene_planes_fwd": "p" * 4 + "i" * 8 + "p",
    "scene_planes_bwd": "p" * 3 + "ap" + "i" * 8 + "p",
}, flags=("-fmad=false",))
build_kernels = LIBRARY.build
launch_counts, reset_launch_counts = LIBRARY.launch_counts, LIBRARY.reset_launch_counts


def pack_constants(scene, stamps, bands):
    """The kernels' constants as NumPy arrays: (float32 per plane band the
    WCS affine, iota and the PSF components, then the galaxy profile's
    amplitudes and variances; int32 per source its kind and offset in the
    state, then per plane band its state band), in the layout
    ``csrc/scene_planes.cu`` describes."""
    from celeste_tpu_torch.model.galaxy import _VARS, DEV_AMPS, EXP_AMPS

    def host(t):
        return np.asarray(t.detach().cpu(), np.float32)

    floats = []
    for st in stamps:
        psf = np.concatenate([host(st.psf.w)[:, None], host(st.psf.mu),
                              host(st.psf.cov).reshape(-1, 4)], axis=1)
        floats += [host(st.wcs_A).reshape(4), host(st.wcs_p0).reshape(2),
                   host(st.iota).reshape(1), psf.reshape(-1)]
    floats += [np.concatenate([EXP_AMPS, DEV_AMPS]).astype(np.float32),
               np.asarray(_VARS, np.float32)]
    return np.concatenate(floats), np.concatenate([source_table(scene),
                                                   np.asarray(bands, np.int32)])


class ScenePlanes(ScenePair):
    """``planes(vecs [B, D_total]) -> [(amp, mx, my, pa, pb, pc) per band]``,
    each plane [B, W] float32: the planes of ``stamps[q]`` in state band
    ``bands[q]``, which ``tiled_field_loglik`` takes."""

    def __init__(self, scene, stamps, bands):
        from celeste_tpu_torch.kernels.tiled_field import scene_planes_blocked, scene_planes_padded
        from celeste_tpu_torch.model.galaxy import N_GAL

        self.stamps, self.bands = list(stamps), [int(b) for b in bands]
        if len(self.stamps) != len(self.bands):
            raise ValueError(f"{len(self.stamps)} stamps but {len(self.bands)} bands")
        self.n_comp = k = self.stamps[0].psf.n_components
        if any(st.psf.n_components != k for st in self.stamps):
            raise ValueError("all bands must share the PSF component count")
        mixed = len(set(scene.kinds)) > 1
        self._plain_band = scene_planes_blocked if mixed else scene_planes_padded
        self.src_w = k if not mixed and scene.kinds[0] == "star" else N_GAL * k
        # the sentinel slot: K columns wide in the block-slot layout, one
        # source wide in the source-major one
        self.plane_w = scene.n_sources * self.src_w + (k if mixed else self.src_w)
        super().__init__(scene, self.stamps[0].counts.device)

    def pack(self):
        if len(self.bands) > MAX_BANDS:
            raise ValueError(f"ScenePlanes takes at most {MAX_BANDS} bands")
        if any(not 0 <= b < self.scene.n_bands for b in self.bands):
            raise ValueError(f"bands {self.bands} outside the state's {self.scene.n_bands}")
        return pack_constants(self.scene, self.stamps, self.bands)

    def plain(self, vecs):
        """Every band's planes through the plain per-band function."""
        return [self._plain_band(self.scene, vecs, st, b) for st, b in zip(self.stamps, self.bands)]

    def launch(self, vecs):
        flat = _ScenePlanesKernel.apply(self, vecs)
        return [flat[6 * q:6 * q + 6] for q in range(len(self.bands))]

    def fwd(self, vecs):
        planes = scene_planes_fwd_cuda(self, vecs)
        return tuple(planes.reshape(-1, *planes.shape[2:]).unbind(0))

    def bwd(self, vecs, cotangents):
        return scene_planes_bwd_cuda(self, vecs, cotangents)

    def _dims(self, b):
        return (b, self.d_total, self.scene.n_sources, self.scene.n_bands, len(self.bands),
                self.n_comp, self.src_w, self.plane_w)


def scene_planes_fwd_cuda(prep: ScenePlanes, vecs):
    """Launch the forward: every band's planes [n_bands, 6, B, W] of the
    contiguous states ``vecs``."""
    prep.check(vecs)
    b = vecs.shape[0]
    planes = torch.empty(len(prep.bands), 6, b, prep.plane_w, dtype=torch.float32,
                         device=vecs.device)
    if b:
        LIBRARY.launch("scene_planes_fwd", vecs.device, vecs.data_ptr(), prep.consts.data_ptr(),
                       prep.table.data_ptr(), planes.data_ptr(), *prep._dims(b))
    return planes


def scene_planes_bwd_cuda(prep: ScenePlanes, vecs, cotangents):
    """Launch the backward: the gradient [B, D_total] of the states from the
    cotangents of every band's six planes (6 * n_bands tensors [B, W], band
    by band; None is a zero cotangent)."""
    prep.check(vecs)
    b = vecs.shape[0]
    if len(cotangents) != 6 * len(prep.bands):
        raise ValueError(f"{len(cotangents)} cotangents for {len(prep.bands)} bands")
    cots = [None if g is None else g.contiguous() for g in cotangents]
    for g in cots:
        if g is not None:
            check_tensor(g, "a cotangent", (b, prep.plane_w), vecs.device)
    grad = torch.empty_like(vecs)
    if b:
        ptrs = (ctypes.c_void_p * len(cots))(*[None if g is None else g.data_ptr()
                                               for g in cots])
        LIBRARY.launch("scene_planes_bwd", vecs.device, vecs.data_ptr(), prep.consts.data_ptr(),
                       prep.table.data_ptr(), ptrs, grad.data_ptr(), *prep._dims(b))
    return grad


class _ScenePlanesKernel(SceneFunction):
    """The plane pair under autograd."""
