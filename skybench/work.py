"""The work one joint value-and-gradient needs, counted from the data and
not from the program's tiling, and the least time the card could take for
it at its published peaks.

A (pixel, component) term is needed where the pixel lies within the
support radius of the component's block around its source's true position
(``reference.support``'s rule, the model's own truncation).  The work of
one gradient at ``chains`` chains, summed over the bands:

- forward: per term the offsets and the quadratic form (9 operations), the
  amplitude times the exponential summed into lambda (2) and one
  exponential; per pixel the Poisson term (4) and one logarithm;
- backward (the moment form): per term the form again (9), the six pixel
  moments (12) and the exponential again; per pixel the cotangent of
  lambda (6); per live component the epilogue (12);
- bytes: the six planes of the live components read once and their six
  cotangents written once, the five pixel arrays read once, the output and
  its cotangent ([chains] each) once.

A multiply-add counts as two operations, as the peak counts it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3, float32
# outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz), and the
# special-function unit's exponentials and logarithms, 16 per clock per SM
# (CUDA C++ Programming Guide, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SPECIAL_PER_S = 132 * 16 * 1.98e9

FLOPS_TERM_FORM, FLOPS_TERM_SUM, FLOPS_TERM_MOMENTS = 9, 2, 12
FLOPS_ENTRY_EPILOGUE = 12
FLOPS_PIXEL_LOGLIK, FLOPS_PIXEL_GLAM = 4, 6
F4 = 4


@dataclass(frozen=True)
class Work:
    flops: float
    special: float
    nbytes: float

    def least_s(self):
        """(least seconds, what bounds it) at the card's peaks."""
        times = {"operations": self.flops / FP32_FLOPS_PER_S,
                 "special functions": self.special / SPECIAL_PER_S,
                 "bytes": self.nbytes / HBM_BYTES_PER_S}
        by = max(times, key=times.get)
        return times[by], by


def needed_terms(field) -> list[int]:
    """Per band, the (pixel, component) pairs of one chain whose pixel lies
    within its block's support radius of its source's true position."""
    h, w = field.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for band in range(field.n_bands):
        n_psf = field.psf_w.shape[1]
        total = 0
        for (x0, y0), radii in zip(field.pos_px, field.radii):
            d2 = (xx - x0) ** 2 + (yy - y0) ** 2
            for r in radii[radii > 0]:
                total += int(np.count_nonzero(d2 <= r * r)) * n_psf
        out.append(total)
    return out


def live_components(field) -> int:
    """Components of one band whose block is not dropped."""
    return int(np.count_nonzero(field.radii > 0)) * field.psf_w.shape[1]


def gradient_work(field, chains: int) -> Work:
    """The counted work of one joint value-and-gradient at ``chains``."""
    terms = chains * sum(needed_terms(field))
    pix_per_band = int(np.prod(field.shape))
    pixels = chains * int(np.count_nonzero(field.mask))
    entries = chains * live_components(field) * field.n_bands
    flops = (terms * (2 * FLOPS_TERM_FORM + FLOPS_TERM_SUM + FLOPS_TERM_MOMENTS)
             + pixels * (FLOPS_PIXEL_LOGLIK + FLOPS_PIXEL_GLAM) + entries * FLOPS_ENTRY_EPILOGUE)
    special = 2 * terms + pixels
    nbytes = (2 * 6 * entries + 5 * pix_per_band * field.n_bands + 2 * chains) * F4
    return Work(float(flops), float(special), float(nbytes))
