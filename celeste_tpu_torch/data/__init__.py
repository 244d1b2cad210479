"""Data layer: synthetic stamp generation and SDSS ingest (counterpart of
``celeste_tpu/data``)."""

from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, SyntheticScene  # noqa: F401
