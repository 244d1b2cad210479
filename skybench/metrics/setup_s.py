"""Set-up time: process start to the first step of the window (the field,
the kernels' load and the sampler's warmup and adaptation)."""


def read(rec):
    return rec.setup_s
