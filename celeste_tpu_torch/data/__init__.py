"""Data layer: synthetic stamp generation (counterpart of
``celeste_tpu/data``; SDSS ingest is not ported yet)."""

from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, SyntheticScene  # noqa: F401
