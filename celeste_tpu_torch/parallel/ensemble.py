"""Sharded chain ensembles (counterpart of ``celeste_tpu/parallel/ensemble.py``):
the chains of an ensemble split over the mesh's ``chains`` dimension.

Each ``chains`` rank holds a contiguous block of the chains
(``mesh.chain_sharding``); the ranks of a ``sources`` group hold the same
block.  A :class:`ChainShard` tells a sampler which block it holds: the
sampler draws its momenta and uniforms at the whole ensemble's shape from
one generator seeded alike on every rank, and keeps its rows, so a sharded
run is the same Markov chain as one process running every chain (the
contract of ``tests/test_parallel.py:54-68`` in the JAX package).  The
per-chain work never communicates; what is pooled across chains (ChEES's
adaptation statistics, the diagnostics) is summed over the ``chains`` group.
"""

from __future__ import annotations

import torch

from celeste_tpu_torch.inference.chees import chees_warmup, run_chees_ensemble
from celeste_tpu_torch.inference.diagnostics import ess, split_rhat
from celeste_tpu_torch.inference.runner import run_chains_ensemble
from celeste_tpu_torch.parallel.collectives import all_reduce_sum, gather_axis
from celeste_tpu_torch.parallel.mesh import chain_sharding


class ChainShard:
    """This rank's block of an ensemble of ``n_global`` chains on ``mesh``."""

    def __init__(self, mesh, n_global: int):
        self.mesh = mesh
        self.n_global = int(n_global)
        self.rows = chain_sharding(mesh, self.n_global)

    def normal(self, gen, like):
        """Standard normals shaped like ``like`` [n_local, ...]: this rank's
        rows of one draw for the whole ensemble."""
        full = torch.randn((self.n_global,) + tuple(like.shape[1:]), generator=gen,
                           dtype=like.dtype, device=like.device)
        return full[self.rows]

    def uniform(self, gen, like):
        """Uniforms on [0, 1) shaped like ``like`` [n_local]: this rank's rows
        of one draw for the whole ensemble."""
        full = torch.rand(self.n_global, generator=gen, dtype=like.dtype, device=like.device)
        return full[self.rows]

    def sum(self, x):
        """Sum of every ``chains`` rank's ``x`` (a per-rank partial sum)."""
        return all_reduce_sum(x, self.mesh, "chains")


def shard_chains(tree, mesh):
    """This rank's rows of a chain-batched state: every tensor of ``tree``
    (a tensor or a tuple / NamedTuple of them) with a leading chain axis is
    sliced to the rank's block; 0-d tensors are kept whole."""
    if isinstance(tree, torch.Tensor):
        return tree[chain_sharding(mesh, tree.shape[0])] if tree.dim() else tree
    return type(tree)(*(shard_chains(t, mesh) for t in tree))


def run_sharded_ensemble(gen, kernel, init_states, n_steps: int, mesh, thin: int = 1):
    """``run_chains_ensemble`` on this rank's chains of ``init_states`` (the
    whole ensemble's initial states, alike on every rank).  ``kernel`` must
    draw through the ensemble's :class:`ChainShard` (``mh_kernel(...,
    chains=ChainShard(mesh, n_chains))``), and ``gen`` must be seeded alike
    on every rank.  Returns this rank's (samples, final state, infos)."""
    return run_chains_ensemble(gen, kernel, shard_chains(init_states, mesh), n_steps, thin)


def run_sharded_chees(gen, logdensity_fn, xs0, mesh, n_warmup: int = 100, n_steps: int = 400,
                      **chees_kw):
    """ChEES-HMC on an ensemble whose chains are sharded over ``mesh``.

    ``xs0`` [n_chains, D]: the whole ensemble's start, alike on every rank;
    ``gen`` seeded alike on every rank; ``logdensity_fn`` maps this rank's
    [n_local, D] chains to [n_local] (it may itself be sharded over
    ``sources``).  The warmup's pooled statistics and the run's mean
    acceptance and divergence rate are all-reduced over ``chains``, so every
    rank adapts the same (eps, T).  The warmup and the run draw from ``gen``
    in turn.

    Returns (this rank's samples [n_local, n_steps, D], its final state,
    eps, T, ChEESInfo of per-step means over every chain).
    """
    chains = ChainShard(mesh, xs0.shape[0])
    state, eps, traj = chees_warmup(gen, logdensity_fn, xs0[chains.rows], n_warmup=n_warmup,
                                    chains=chains, **chees_kw)
    samples, state, info = run_chees_ensemble(
        gen, logdensity_fn, state, n_steps=n_steps, step_size=eps, trajectory_length=traj,
        max_leapfrog=chees_kw.get("max_leapfrog", 256), chains=chains)
    return samples, state, eps, traj, info


def ensemble_diagnostics(samples, mesh=None):
    """Split-R-hat, ESS, mean and std over every chain of a sample array
    [n_local, n_steps, D] whose chains are sharded over ``mesh`` (gathered
    over ``chains`` first; no mesh: the array is the whole ensemble)."""
    full = gather_axis(samples, mesh, "chains", tiled=True)
    flat = full.reshape(-1, full.shape[-1])
    return {"rhat": split_rhat(full), "ess": ess(full), "mean": torch.mean(flat, 0),
            "std": torch.std(flat, 0, correction=0)}
