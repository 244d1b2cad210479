"""Per-source block-Gibbs sweeps, batch-major over chains (counterpart of
``celeste_tpu/inference/gibbs.py``).

A sweep visits the source blocks in order; each block update is a
random-walk MH proposal on that block alone, accepted or rejected per
chain.  Red/black colouring updates non-overlapping sources together: the
sources of one colour share one proposal, valid because their conditionals
factorise when their stamps do not overlap (and still a correct MH kernel
on the joint state when they do).

States hold every chain: ``x`` [B, D_total], ``logp`` [B].
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class GibbsState(NamedTuple):
    x: torch.Tensor      # [B, D_total] joint vectors
    logp: torch.Tensor   # [B]


class GibbsInfo(NamedTuple):
    accepted: torch.Tensor   # [B, n_blocks] per-block acceptance this sweep
    logp: torch.Tensor       # [B]


def gibbs_init(x0, logdensity_fn) -> GibbsState:
    return GibbsState(x=x0, logp=logdensity_fn(x0))


def _mh_masked(gen, logdensity_fn, x, logp, mask_scales):
    """One MH proposal x + mask_scales * noise of every chain, accepted per
    chain.  Returns (x, logp, accepted [B])."""
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    prop = x + mask_scales * noise
    logp_prop = logdensity_fn(prop)
    u = torch.rand(x.shape[0], generator=gen, dtype=x.dtype, device=x.device)
    accept = torch.log(u) < (logp_prop - logp)
    return (torch.where(accept[:, None], prop, x), torch.where(accept, logp_prop, logp),
            accept)


def _masked_sweep(logdensity_fn, masks, step_scales):
    """A sweep over the rows of ``masks`` [n, D] (1 on the coordinates each
    proposal moves)."""

    def step(gen, state: GibbsState):
        x, logp = state.x, state.logp
        scales = torch.as_tensor(step_scales, dtype=x.dtype, device=x.device)
        m = torch.as_tensor(masks, dtype=x.dtype, device=x.device)
        accepted = []
        for i in range(m.shape[0]):
            x, logp, acc = _mh_masked(gen, logdensity_fn, x, logp, m[i] * scales)
            accepted.append(acc)
        return GibbsState(x=x, logp=logp), GibbsInfo(accepted=torch.stack(accepted, 1),
                                                     logp=logp)

    return step


def _block_masks(blocks, groups, n_groups, d_total):
    """[n_groups, D] masks: block j's coordinates in row groups[j].
    ``blocks`` are (offset, width) pairs or the (offset, width, kind)
    triples ``CrowdedScene.block_slices()`` gives."""
    masks = np.zeros((n_groups, d_total), np.float32)
    for blk, g in zip(blocks, groups):
        off, w = int(blk[0]), int(blk[1])
        masks[int(g), off:off + w] = 1.0
    return masks


def block_gibbs_kernel(logdensity_fn, blocks: Sequence[tuple], step_scales):
    """Build a sweep kernel ``(generator, state) -> (state, info)``.

    ``blocks``: one (offset, width) slice of the joint vector per source
    (from ``CrowdedScene.block_slices``).  ``step_scales``: [D_total]
    per-coordinate proposal scales."""
    d_total = int(torch.as_tensor(step_scales).shape[0])
    masks = _block_masks(blocks, range(len(blocks)), len(blocks), d_total)
    return _masked_sweep(logdensity_fn, masks, step_scales)


def color_sources(positions, radius: float):
    """Greedy graph colouring of sources by overlap (host-side NumPy):
    sources closer than ``radius`` (arcsec) share an edge and get different
    colours.  Returns an int array [S] of colours; sources of one colour can
    update in parallel (their likelihood blocks don't interact)."""
    pos = np.asarray(positions, np.float64)
    s = pos.shape[0]
    colors = np.full(s, -1, np.int64)
    for i in range(s):
        d = np.sqrt(np.sum((pos[:i] - pos[i]) ** 2, axis=1))
        neighbor_colors = {int(colors[j]) for j in range(i) if d[j] < radius}
        c = 0
        while c in neighbor_colors:
            c += 1
        colors[i] = c
    return colors


def colored_gibbs_kernel(logdensity_fn, blocks: Sequence[tuple], colors, step_scales):
    """Red/black (multi-colour) Gibbs: one MH proposal jointly moves every
    source of a colour class, the classes in turn.  Exact when the
    colouring is valid; a correct MH kernel on the joint state either way.
    ``info.accepted`` is [B, n_colors]."""
    colors = np.asarray(colors)
    d_total = int(torch.as_tensor(step_scales).shape[0])
    masks = _block_masks(blocks, colors, int(colors.max()) + 1, d_total)
    return _masked_sweep(logdensity_fn, masks, step_scales)
