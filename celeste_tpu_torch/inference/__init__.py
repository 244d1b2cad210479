"""Inference layer: batch-major MCMC kernels and the chain runner
(counterpart of ``celeste_tpu/inference``).

Every kernel is a ``(generator, state) -> (state, info)`` step over a
[B, D] batch of chains; time is a Python loop.  Ported so far: MH, HMC with
its adaptive warmup, diagnostics and the star posterior.  Slice, NUTS,
ChEES, whitening and the rest are listed in ROADMAP.md.
"""

from celeste_tpu_torch.inference.mh import mh_init, mh_kernel  # noqa: F401
from celeste_tpu_torch.inference.hmc import (  # noqa: F401
    hmc_init,
    hmc_kernel,
    hmc_warmup,
    hmc_warmup_finish,
    hmc_warmup_init,
    hmc_warmup_window,
)
from celeste_tpu_torch.inference.runner import run_chains_ensemble  # noqa: F401
from celeste_tpu_torch.inference.diagnostics import ess, split_rhat, summarize  # noqa: F401
