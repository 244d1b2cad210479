"""Numerical guards (counterpart of ``celeste_tpu/utils/guards.py``): on the
device the hazards are NaN and Inf, not data races.

``checked_logdensity`` wraps a batched log-density with finite checks on
the value and the gradient, for debugging runs; the samplers instead rely
on masked finite handling (NUTS and ChEES treat non-finite energies as
divergences, MH rejects them), so no check lands in the hot loop.
"""

from __future__ import annotations

import torch


def checked_logdensity(logdensity_fn):
    """Return ``(checked, run)`` for a log-density ``[B, D] -> [B]``:
    ``checked(x)`` gives ``(error, logp)``, ``error`` a message naming the
    first chains whose log-density or gradient is not finite (None when all
    are), and ``run(x)`` returns ``logp`` or raises ``FloatingPointError``
    with that message.  Debug tool: one gradient per call."""
    # imported here: inference.hmc imports utils.profiling, which loads this package
    from celeste_tpu_torch.inference.hmc import value_and_grad

    def checked(x):
        logp, grad = value_and_grad(logdensity_fn, x)
        for what, bad in (("log density", ~torch.isfinite(logp)),
                          ("gradient", ~torch.isfinite(grad).all(dim=-1))):
            if bool(bad.any()):
                rows = torch.nonzero(bad).flatten()[:8].tolist()
                return f"non-finite {what} at chains {rows}", logp
        return None, logp

    def run(x):
        err, logp = checked(x)
        if err is not None:
            raise FloatingPointError(err)
        return logp

    return checked, run
