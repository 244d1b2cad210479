"""Checkpoint / resume (counterpart of ``celeste_tpu/utils/checkpoint.py``).

Sampler states are nested NamedTuples, dicts, lists and tuples of tensors,
so save(state) + load + continue is bitwise equivalent to an uninterrupted
run when the random streams are derived from (seed, segment) and not from
how far a generator has advanced (``utils.rng``).

Format: a flat ``np.savez`` of the leaves (``leaf_0``, ``leaf_1``, ...) in
depth-first order, NamedTuple fields in order and dict keys sorted, with a
JSON ``__meta__`` holding the structure record: every node's type name and
field names (or keys) and its nesting, one ``*`` per leaf.  JAX records its
``treedef`` string there instead; ``interop.load_jax_checkpoint`` reads
those files.  Writes are atomic: a temporary file, then ``os.replace``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_SCALARS = (bool, int, float)


def _flatten(tree, leaves: list) -> str:
    """The structure record of ``tree``; its leaves are appended to ``leaves``."""
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _SCALARS):
        leaves.append(tree)
        return "*"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        body = ", ".join(f"{f}={_flatten(getattr(tree, f), leaves)}" for f in tree._fields)
        return f"{type(tree).__name__}({body})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(_flatten(t, leaves) for t in tree)
        return f"[{body}]" if isinstance(tree, list) else f"({body})"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def flatten(tree):
    """(leaves in checkpoint order, structure record) of ``tree``."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(next(leaves))).to(like.device)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.array(next(leaves))
    if isinstance(like, _SCALARS):
        return type(like)(next(leaves).item())
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return type(like)(_unflatten(t, leaves) for t in like)


def unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` (NumPy arrays in checkpoint
    order); tensors go to the device of ``like``'s tensor in that slot."""
    return _unflatten(like, iter(leaves))


def leaf_dtype(leaf) -> np.dtype:
    """The NumPy dtype a leaf is saved as."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.result_type(getattr(leaf, "dtype", type(leaf)))


def check_leaves(leaves, flat_like):
    """Raise unless every saved leaf has the shape and dtype of its slot."""
    for i, (leaf, ref) in enumerate(zip(leaves, flat_like)):
        ref_shape, ref_dtype = tuple(np.shape(ref)), leaf_dtype(ref)
        if tuple(leaf.shape) != ref_shape or np.dtype(leaf.dtype) != ref_dtype:
            raise ValueError(f"checkpoint leaf {i} is {leaf.dtype}{list(leaf.shape)} but "
                             f"the target slot expects {ref_dtype}{list(ref_shape)}")


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state, step: int | None = None, extra: dict | None = None):
    """Write ``state`` to ``path`` atomically (a temporary file, then rename)."""
    leaves, structure = flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    meta = {"structure": structure, "n_leaves": len(leaves), "step": step,
            "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """Load into the structure of ``like`` (the structure saved).  Returns
    (state, step, extra); tensors land on the devices of ``like``'s.

    Validates structure, not just leaf count: a different structure (or
    different leaf shapes/dtypes) with the same number of leaves would
    silently map arrays into the wrong slots and break the bitwise-resume
    guarantee, so both are checked against the save-time record.
    """
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat_like, structure = flatten(like)
        n = meta["n_leaves"]
        if n != len(flat_like):
            raise ValueError(f"checkpoint has {n} leaves, target structure has {len(flat_like)}")
        if meta.get("structure") != structure:
            raise ValueError("checkpoint structure does not match the target structure:\n"
                             f"  saved:  {meta.get('structure')}\n  target: {structure}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    check_leaves(leaves, flat_like)
    return unflatten(like, leaves), meta.get("step"), meta.get("extra", {})
