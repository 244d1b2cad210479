"""Benchmark scenes of the port (counterpart of ``celeste_tpu/bench``)."""
