"""Chain runner: a Python loop over time on a [B, D] batch of chains
(counterpart of ``celeste_tpu/inference/runner.py``)."""

from __future__ import annotations

import torch


def run_chains_ensemble(gen, kernel, init_state, n_steps: int, thin: int = 1,
                        collect=lambda s, i: s.x):
    """Run ``kernel`` on every chain of ``init_state`` for ``n_steps``.

    ``collect(state, info)`` picks what to record at each kept step (default
    the position); with ``thin`` > 1 only every thin-th state is kept.
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
        samples.append(collect(state, info))
        infos.append(info)
    stacked = type(infos[0])(*(torch.stack(f, dim=1) for f in zip(*infos)))
    return torch.stack(samples, dim=1), state, stacked


def run_chains(gen, kernel, init_state, n_steps: int, thin: int = 1,
               collect=lambda s, i: s.x):
    """Run one chain (``init_state`` without a chain axis): the B = 1 case
    of :func:`run_chains_ensemble`, with JAX's ``run_chains`` signature but a
    ``torch.Generator`` in place of the key.  Returns (samples [n_kept,
    ...], final_state, infos with each field [n_kept])."""
    one = type(init_state)(*(t[None] for t in init_state))
    samples, state, infos = run_chains_ensemble(gen, kernel, one, n_steps, thin, collect)
    return (samples[0], type(state)(*(t[0] for t in state)),
            type(infos)(*(f[0] for f in infos)))
