"""Chain runner: a Python loop over time on a [B, D] batch of chains
(counterpart of ``celeste_tpu/inference/runner.py``)."""

from __future__ import annotations

import torch


def run_chains_ensemble(gen, kernel, init_state, n_steps: int, thin: int = 1):
    """Run ``kernel`` on every chain of ``init_state`` for ``n_steps``.

    The position is recorded at each kept step; with ``thin`` > 1 only every
    thin-th state is kept.
    Returns (samples [n_chains, n_kept, ...], final_state, infos), where each
    field of ``infos`` is stacked to [n_chains, n_kept].
    """
    if n_steps % thin:
        raise ValueError(f"n_steps={n_steps} must be divisible by thin={thin}")
    state = init_state
    samples, infos = [], []
    for _ in range(n_steps // thin):
        for _ in range(thin):
            state, info = kernel(gen, state)
        samples.append(state.x)
        infos.append(info)
    stacked = type(infos[0])(*(torch.stack(f, dim=1) for f in zip(*infos)))
    return torch.stack(samples, dim=1), state, stacked
