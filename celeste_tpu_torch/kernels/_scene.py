"""The shell shared by the scene-kernel pairs, ``scene_planes.ScenePlanes``
and ``scene_prior.ScenePrior``: kernels over a joint state [B, D_total]
that read each source's kind and offset in the state from a table.

A pair is built once per log density.  On a CUDA device it uploads its
constants and the table once, so a call copies nothing from the host and
synchronises nothing.  A call dispatches by the states' device, with no
switch and no fallback: CPU states take the plain version, differentiated
by autograd; CUDA states take the forward launch under an autograd
function whose gradient is the backward launch and which saves only the
states.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.kernels._build import check_tensor

MAX_BANDS = 8                    # csrc/scene_planes.cu, csrc/scene_prior.cu kMaxBands


def source_table(scene):
    """Each source's (kind, offset in the state), kind 1 for a galaxy, as a
    flat int32 array [2 S]: the head of either pair's table."""
    blocks, _ = scene.block_slices()
    return np.asarray([[int(kind == "galaxy"), off] for off, _, kind in blocks],
                      np.int32).reshape(-1)


class ScenePair:
    """A subclass defines :meth:`pack` (its constants as a float32 and an
    int32 array), :meth:`plain` (the CPU version), :meth:`launch` (the pair
    under autograd) and the ``fwd`` / ``bwd`` launches its autograd function
    calls."""

    def __init__(self, scene, device):
        self.scene, self.d_total = scene, scene.dim
        self.consts = self.table = None
        device = torch.device(device)
        if device.type == "cuda":
            if scene.n_bands > MAX_BANDS:
                raise ValueError(f"{type(self).__name__} takes at most {MAX_BANDS} bands")
            consts, table = self.pack()
            self.consts = torch.as_tensor(consts, device=device)
            self.table = torch.as_tensor(table, device=device)

    def __call__(self, vecs):
        if vecs.device.type == "cpu":
            return self.plain(vecs)
        if vecs.device.type != "cuda":
            raise ValueError(f"{type(self).__name__} has no implementation on {vecs.device}")
        return self.launch(vecs)

    def check(self, vecs):
        """Raise unless ``vecs`` is a contiguous float32 [B, D_total] tensor
        on the device of the constants."""
        if self.consts is None:
            raise ValueError(f"states on {vecs.device}, {type(self).__name__}'s constants on "
                             f"no CUDA device")
        check_tensor(vecs, "states", vecs.shape[:1] + (self.d_total,), self.consts.device)


class SceneFunction(torch.autograd.Function):
    """The forward launch, with the backward launch as its gradient; only
    the states are saved."""

    @staticmethod
    def forward(ctx, pair, vecs):
        vecs = vecs.contiguous()
        ctx.save_for_backward(vecs)
        ctx.pair = pair
        return pair.fwd(vecs)

    @staticmethod
    def backward(ctx, *grads):
        (vecs,) = ctx.saved_tensors
        return None, ctx.pair.bwd(vecs, grads)
