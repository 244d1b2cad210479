"""Faults planted under the timed path: the readings that set the upper
end of a limit take them on the card, and the tests see a run with each
come out not correct.  Each wraps the program's
``inference.chees.run_chees_ensemble``, which the window alone calls, so
the set-up stays sound:

- ``unchanged``: a step returns its state unchanged;
- ``half_batch``: half of the batch left out, its log densities replaced by
  the mean of the rest;
- ``altered``: one chain's state altered where the step produces it;
- ``accept_all``: the Metropolis test accepts every proposal that did not
  diverge;
- ``stale_momentum``: the momentum is drawn once and never refreshed.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    had = name in vars(owner)
    old = vars(owner).get(name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        if had:
            setattr(owner, name, old)
        else:
            delattr(owner, name)


def _unchanged(real, chees):
    def run(gen, logd, state, n_steps, **kw):
        _, _, info = real(gen, logd, state, n_steps, **kw)
        return state.xs[:, None].expand(-1, n_steps, -1), state, info
    return run


def _half_batch(real, chees):
    def run(gen, logd, state, n_steps, **kw):
        def halved(x):
            lp = logd(x)
            h = lp.shape[0] // 2
            return torch.cat([lp[:h], lp[:h].mean().expand(lp.shape[0] - h)])
        return real(gen, halved, state, n_steps, **kw)
    return run


def _altered(real, chees):
    def run(gen, logd, state, n_steps, **kw):
        samples, st, info = real(gen, logd, state, n_steps, **kw)
        xs = st.xs.clone()
        xs[0] += 0.5
        return samples, chees.ChEESState(xs, st.logps, st.grads), info
    return run


def _accept_all(real, chees):
    def run(gen, logd, state, n_steps, **kw):
        with _patched(chees.Groups, "uniform", lambda self, gen, like: torch.zeros_like(like)):
            return real(gen, logd, state, n_steps, **kw)
    return run


def _stale_momentum(real, chees):
    drawn = {}
    fresh = chees.Groups.normal

    def normal(self, gen, like):
        key = tuple(like.shape)
        if key not in drawn:
            drawn[key] = fresh(self, gen, like)
        return drawn[key]

    def run(gen, logd, state, n_steps, **kw):
        with _patched(chees.Groups, "normal", normal):
            return real(gen, logd, state, n_steps, **kw)
    return run


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered,
          "accept_all": _accept_all, "stale_momentum": _stale_momentum}


@contextlib.contextmanager
def planted(name: str | None):
    """The window's sampler broken by fault ``name`` (None: sound)."""
    if name is None:
        yield
        return
    from celeste_tpu_torch.inference import chees

    real = chees.run_chees_ensemble
    with _patched(chees, "run_chees_ensemble", FAULTS[name](real, chees)):
        yield
