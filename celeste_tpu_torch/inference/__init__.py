"""Inference layer: batch-major MCMC kernels and the chain runner
(counterpart of ``celeste_tpu/inference``).

Every kernel is a ``(generator, state) -> (state, info)`` step over a
[B, D] batch of chains; time is a Python loop.  MH, slice, HMC with its
adaptive warmup, NUTS, ChEES-HMC with its ensemble warmup, the dense-metric
whitening, parallel tempering (the ladder an axis of the batch), block and
red/black Gibbs, the affine-invariant stretch move, diagnostics and the
star and galaxy posteriors; MAP fitting (``map_fit``), Laplace model
selection (``model_select``) and Carlin-Chib type switching
(``type_switch``) are imported from their modules.  ``inference/vg.py`` of
the JAX package has no counterpart (batch-major samplers need no
``custom_vmap``).
"""

from celeste_tpu_torch.inference.mh import mh_init, mh_kernel  # noqa: F401
from celeste_tpu_torch.inference.slice_ import SliceInfo, SliceState, slice_init, slice_kernel  # noqa: F401
from celeste_tpu_torch.inference.hmc import (  # noqa: F401
    HMCState,
    hmc_init,
    hmc_kernel,
    hmc_warmup,
    hmc_warmup_finish,
    hmc_warmup_init,
    hmc_warmup_window,
)
from celeste_tpu_torch.inference.nuts import NUTSInfo, nuts_kernel  # noqa: F401
from celeste_tpu_torch.inference.chees import (  # noqa: F401
    ChEESAdaptState,
    ChEESInfo,
    ChEESState,
    chees_init,
    chees_warmup,
    chees_warmup_finish,
    chees_warmup_init,
    chees_warmup_window,
    run_chees_ensemble,
)
from celeste_tpu_torch.inference.whiten import (  # noqa: F401
    dense_metric_from_probe,
    ensemble_covariance,
    whiten_logdensity,
    whitened_chees_run,
)
from celeste_tpu_torch.inference.runner import run_chains, run_chains_ensemble  # noqa: F401
from celeste_tpu_torch.inference.gibbs import (  # noqa: F401
    GibbsInfo,
    GibbsState,
    block_gibbs_kernel,
    color_sources,
    colored_gibbs_kernel,
    gibbs_init,
)
from celeste_tpu_torch.inference.ensemble_stretch import (  # noqa: F401
    StretchInfo,
    StretchState,
    stretch_init,
    stretch_kernel,
)
from celeste_tpu_torch.inference.diagnostics import ess, split_rhat, summarize  # noqa: F401
from celeste_tpu_torch.inference.tempering import (  # noqa: F401
    PTInfo,
    PTState,
    geometric_ladder,
    hmc_at_beta,
    hmc_at_beta_adaptive,
    mh_at_beta,
    pt_init,
    pt_kernel,
    pt_warmup,
    slice_at_beta,
)
