"""Divergent transitions over attempted ones in the window, from the
sampler's own per-step divergence rates."""


def read(rec):
    return 100.0 * rec.window["divergence_share"]
