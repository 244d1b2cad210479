"""Auxiliary subsystems: structured metrics (checkpointing, profiling and
guards are not ported yet)."""

from celeste_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
