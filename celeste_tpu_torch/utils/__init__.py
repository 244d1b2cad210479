"""Auxiliary subsystems (counterpart of ``celeste_tpu/utils``): checkpoints,
structured metrics, profiling, numerical guards, and named random streams."""

from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from celeste_tpu_torch.utils.metrics import MetricsLogger, device_log  # noqa: F401
from celeste_tpu_torch.utils.profiling import named_scope, timed, trace_context  # noqa: F401
from celeste_tpu_torch.utils.guards import checked_logdensity  # noqa: F401
from celeste_tpu_torch.utils.rng import derive_seed, seeded_generator  # noqa: F401
