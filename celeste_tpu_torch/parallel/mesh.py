"""Device meshes over ``torch.distributed`` (counterpart of
``celeste_tpu/parallel/mesh.py``), and the launcher that starts their ranks.

JAX drives every device of a mesh from one process.  PyTorch runs one
process per rank, each running the same program (SPMD): a mesh is a
``DeviceMesh`` (``torch.distributed.device_mesh``) whose dimensions are
named ``chains`` and ``sources``, with one process group per dimension.

- :func:`launch` starts N ranks on this host (``torch.multiprocessing``
  spawn) around a file store in a temporary directory, so that concurrent
  launches never contend for a port, runs a function on each and returns
  each rank's result.  It is the counterpart of the JAX dry run's
  re-execution on a virtual CPU mesh (``__graft_entry__.py:89-111``).
- :func:`process_group` makes this process rank 0 of a world of one, for
  a caller that runs the sharded code in-process.
- Under ``torchrun`` the ranks come from its environment instead
  (``python -m celeste_tpu_torch.multichip``).

A tensor replicated over the mesh is every rank's whole tensor, so JAX's
``replicated(mesh)`` sharding needs no counterpart; ``chain_sharding``
gives the rows a rank holds of a chain-sharded one.

The backend is the caller's choice: NCCL for one card per rank, gloo for
the CPU lane and for several ranks on one card (NCCL refuses two ranks on
one device; gloo on CUDA tensors takes only ``all_reduce`` and
``broadcast``, which is why ``collectives.py`` builds every collective from
``all_reduce``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TIMEOUT = timedelta(seconds=600)     # a rank that waits longer on a collective raises


def make_mesh(axis_sizes: dict | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default process group.

    ``axis_sizes`` maps dimension name -> size, in order; the sizes must
    multiply to the world size.  Default: a 1-D mesh over all ranks named
    ``chains``.  Each dimension's process group uses the default group's
    backend.
    """
    world = dist.get_world_size()
    axis_sizes = dict(axis_sizes or {"chains": world})
    names, sizes = tuple(axis_sizes), tuple(int(n) for n in axis_sizes.values())
    n = 1
    for size in sizes:
        n *= size
    if n != world:
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks, the world has {world}")
    backend = dist.get_backend()
    return init_device_mesh(device_type, sizes, mesh_dim_names=names,
                            backend_override={name: backend for name in names})


def chain_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the chain-ensemble axis, every rank on it."""
    return make_mesh(None, device_type)


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """Ranks along ``name``; 1 for a dimension the mesh lacks."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh | None, name: str) -> int:
    """This rank's coordinate along ``name``; 0 for a dimension the mesh lacks."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh | None, name: str):
    """The process group of this rank's ``name`` dimension, or None where the
    dimension is absent or holds one rank (its collectives are no-ops)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def chain_sharding(mesh: DeviceMesh | None, n_chains: int) -> slice:
    """The rows of a leading chain axis of ``n_chains`` that this rank
    holds: a contiguous block per ``chains`` coordinate, the same on every
    rank of a ``sources`` group."""
    n_shards = axis_size(mesh, "chains")
    if n_chains % n_shards:
        raise ValueError(f"{n_chains} chains do not divide over {n_shards} chain shards")
    per = n_chains // n_shards
    start = axis_index(mesh, "chains") * per
    return slice(start, start + per)


def replicated(mesh: DeviceMesh | None) -> slice:
    """The rows of an axis that every rank holds whole (counterpart of the
    JAX package's replicated ``NamedSharding``): all of them, on any mesh."""
    return slice(None)


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world: int = 1, init_file: str | None = None):
    """Initialise the default process group for the body, and destroy it after.

    ``init_file`` is the file store shared by the world's ranks; by default a
    fresh one in a temporary directory (a world of one).
    """
    with tempfile.TemporaryDirectory(prefix="celeste_pg_") as tmp:
        path = init_file or os.path.join(tmp, "store")
        dist.init_process_group(backend, init_method=f"file://{path}", rank=rank,
                                world_size=world, timeout=TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, fn, world, backend, store, out_dir, args):
    """One spawned rank: one CPU thread, the card ``rank % device_count``
    where there is one, the process group, then ``fn(*args)``, whose result
    goes to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    with process_group(backend, rank, world, store):
        out = fn(*args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def launch(fn, world: int, *args, backend: str = "gloo"):
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group and
    return the list of their results, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable; results come back through ``torch.save``
    files this call writes and reads.  A rank that raises makes the call
    raise, with the rank's traceback, and the other ranks are stopped.
    """
    with tempfile.TemporaryDirectory(prefix="celeste_launch_") as tmp:
        store = os.path.join(tmp, "store")
        torch.multiprocessing.spawn(_rank_main, args=(fn, world, backend, store, tmp, args),
                                    nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
