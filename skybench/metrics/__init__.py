"""Metric readers, one file each, named as the metric in
``BENCHMARK.json`` (which gives its unit, layer and what it moves):
``metrics/<metric>.py`` defines ``read(rec)``, which returns the value, or
``None`` where the record holds nothing to read."""
