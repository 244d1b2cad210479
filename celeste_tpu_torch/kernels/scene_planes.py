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
  uploaded once, when the object is built, so a call copies nothing from the
  host and synchronises nothing.  A build or launch failure raises.
- CPU tensors take the plain version, ``scene_planes_blocked`` (a scene of
  two kinds) or ``scene_planes_padded`` (one kind) of
  ``kernels/tiled_field.py`` once per band, differentiated by autograd.

The layout follows the scene's kinds: the block-slot layout (every source
N_GAL * K columns wide) for a mixed scene, the source-major layout of one
kind otherwise; the last slot is the zero sentinel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

_SOURCES = ("scene_planes.cu",)
# every product and sum rounded on its own, as the plain version's separate
# elementwise operations round them
_FLAGS = ("-fmad=false",)
MAX_BANDS = 8                    # csrc/scene_planes.cu kMaxBands


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scene_planes_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.scene_planes_fwd.restype = i
    lib.scene_planes_bwd.argtypes = [p] * 3 + [ctypes.POINTER(p), p] + [i] * 8 + [p]
    lib.scene_planes_bwd.restype = i
    lib.scene_planes_error_string.argtypes = [i]
    lib.scene_planes_error_string.restype = ctypes.c_char_p


def _lib():
    from celeste_tpu_torch.kernels._build import load_library

    return load_library("scene_planes", _SOURCES, _declare, _FLAGS)


def build_kernels():
    """Build and load the CUDA library now (it is otherwise built at the
    first launch).  Returns the path of the shared library."""
    return Path(_lib()._name)


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
    blocks, _ = scene.block_slices()
    table = [[int(kind == "galaxy"), off] for off, _, kind in blocks]
    table = np.concatenate([np.asarray(table, np.int32).reshape(-1),
                            np.asarray(bands, np.int32)])
    return np.concatenate(floats), table


class ScenePlanes:
    """``planes(vecs [B, D_total]) -> [(amp, mx, my, pa, pb, pc) per band]``,
    each plane [B, W] float32: the planes of ``stamps[q]`` in state band
    ``bands[q]``, which ``tiled_field_loglik`` takes."""

    def __init__(self, scene, stamps, bands):
        from celeste_tpu_torch.kernels.tiled_field import scene_planes_blocked, scene_planes_padded
        from celeste_tpu_torch.model.galaxy import N_GAL

        self.scene, self.stamps, self.bands = scene, list(stamps), [int(b) for b in bands]
        if len(self.stamps) != len(self.bands):
            raise ValueError(f"{len(self.stamps)} stamps but {len(self.bands)} bands")
        self.n_comp = k = self.stamps[0].psf.n_components
        if any(st.psf.n_components != k for st in self.stamps):
            raise ValueError("all bands must share the PSF component count")
        mixed = len(set(scene.kinds)) > 1
        self.plain = scene_planes_blocked if mixed else scene_planes_padded
        self.src_w = k if not mixed and scene.kinds[0] == "star" else N_GAL * k
        # the sentinel slot: K columns wide in the block-slot layout, one
        # source wide in the source-major one
        self.plane_w = scene.n_sources * self.src_w + (k if mixed else self.src_w)
        self.d_total = scene.dim
        self.consts = self.table = None
        device = self.stamps[0].counts.device
        if device.type == "cuda":
            if len(self.bands) > MAX_BANDS or scene.n_bands > MAX_BANDS:
                raise ValueError(f"the plane kernels take at most {MAX_BANDS} bands")
            if any(not 0 <= b < scene.n_bands for b in self.bands):
                raise ValueError(f"bands {self.bands} outside the state's {scene.n_bands}")
            consts, table = pack_constants(scene, self.stamps, self.bands)
            self.consts = torch.as_tensor(consts, device=device)
            self.table = torch.as_tensor(table, device=device)

    def __call__(self, vecs):
        if vecs.device.type == "cpu":
            return [self.plain(self.scene, vecs, st, b) for st, b in zip(self.stamps, self.bands)]
        if vecs.device.type != "cuda":
            raise ValueError(f"scene planes have no implementation on {vecs.device}")
        flat = _ScenePlanesKernel.apply(self, vecs)
        return [flat[6 * q:6 * q + 6] for q in range(len(self.bands))]

    def check(self, vecs):
        """Raise unless ``vecs`` is a float32 [B, D_total] CUDA tensor on the
        device of the constants."""
        if self.consts is None or vecs.device != self.consts.device:
            raise ValueError(f"states on {vecs.device}, the scene's constants on "
                             f"{None if self.consts is None else self.consts.device}")
        if vecs.dtype != torch.float32 or vecs.dim() != 2 or vecs.shape[1] != self.d_total:
            raise ValueError(f"states must be float32 [B, {self.d_total}], got {vecs.dtype} "
                             f"{tuple(vecs.shape)}")

    def _dims(self, b):
        return (b, self.d_total, self.scene.n_sources, self.scene.n_bands, len(self.bands),
                self.n_comp, self.src_w, self.plane_w)


def _raise_on_error(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.scene_planes_error_string(err).decode()} ({err})")


def scene_planes_fwd_cuda(prep: ScenePlanes, vecs):
    """Launch the forward: every band's planes [n_bands, 6, B, W] of the
    contiguous states ``vecs``."""
    prep.check(vecs)
    if not vecs.is_contiguous():
        raise ValueError("states are not contiguous")
    b = vecs.shape[0]
    planes = torch.empty(len(prep.bands), 6, b, prep.plane_w, dtype=torch.float32,
                         device=vecs.device)
    if b:
        lib = _lib()
        with torch.cuda.device(vecs.device):
            stream = torch.cuda.current_stream(vecs.device).cuda_stream
            err = lib.scene_planes_fwd(vecs.data_ptr(), prep.consts.data_ptr(),
                                       prep.table.data_ptr(), planes.data_ptr(), *prep._dims(b),
                                       stream)
        _raise_on_error(lib, err, "scene_planes_fwd")
    scene_planes_fwd_cuda.launches += 1
    return planes


scene_planes_fwd_cuda.launches = 0


def scene_planes_bwd_cuda(prep: ScenePlanes, vecs, cotangents):
    """Launch the backward: the gradient [B, D_total] of the states from the
    cotangents of every band's six planes (6 * n_bands tensors [B, W], band
    by band; None is a zero cotangent)."""
    prep.check(vecs)
    b = vecs.shape[0]
    if len(cotangents) != 6 * len(prep.bands):
        raise ValueError(f"{len(cotangents)} cotangents for {len(prep.bands)} bands")
    cots = []
    for g in cotangents:
        if g is not None:
            g = g.contiguous()
            if g.dtype != torch.float32 or tuple(g.shape) != (b, prep.plane_w) or \
                    g.device != vecs.device:
                raise ValueError(f"a cotangent is {g.dtype} {tuple(g.shape)} on {g.device}, "
                                 f"expected float32 [{b}, {prep.plane_w}] on {vecs.device}")
        cots.append(g)
    grad = torch.empty_like(vecs)
    if b:
        lib = _lib()
        ptrs = (ctypes.c_void_p * len(cots))(*[None if g is None else g.data_ptr()
                                               for g in cots])
        with torch.cuda.device(vecs.device):
            stream = torch.cuda.current_stream(vecs.device).cuda_stream
            err = lib.scene_planes_bwd(vecs.data_ptr(), prep.consts.data_ptr(),
                                       prep.table.data_ptr(), ptrs, grad.data_ptr(),
                                       *prep._dims(b), stream)
        _raise_on_error(lib, err, "scene_planes_bwd")
    scene_planes_bwd_cuda.launches += 1
    return grad


scene_planes_bwd_cuda.launches = 0


class _ScenePlanesKernel(torch.autograd.Function):
    """The forward launch, with the backward launch as its gradient; only
    the states are saved."""

    @staticmethod
    def forward(ctx, prep, vecs):
        vecs = vecs.contiguous()
        planes = scene_planes_fwd_cuda(prep, vecs)
        ctx.save_for_backward(vecs)
        ctx.prep = prep
        return tuple(planes.reshape(-1, *planes.shape[2:]).unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        (vecs,) = ctx.saved_tensors
        return None, scene_planes_bwd_cuda(ctx.prep, vecs, grads)
