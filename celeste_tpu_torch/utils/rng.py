"""Random streams named by a path of integers, the port's counterpart of
JAX's ``fold_in``: a stream's numbers depend on (seed, path) alone, never on
how far another generator has advanced.  A resumed run's segment s, or a
photo-z target t, draws what an unbroken run or a run in another batch
draws there."""

from __future__ import annotations

import numpy as np
import torch


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream (seed, *path), from NumPy's
    ``SeedSequence`` (non-negative integers only)."""
    words = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def seeded_generator(device, seed: int, *path: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for the stream (seed, *path)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, *path))
    return gen
