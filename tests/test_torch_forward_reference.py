"""Two reference gates of the JAX package's forward model, on the port
(tests/test_forward_parity.py:81 and :116), on the CPU.

- The analytic MoG (*) MoG convolution (``mog.convolve``) against a
  brute-force FFT convolution of the two mixtures rendered on a 65x65 grid:
  atol 5e-5, the JAX test's.
- The Poisson term (``likelihood.poisson_loglik(normalized=True)``) against
  ``scipy.stats.poisson.logpmf`` summed over a 7x9 grid: abs 1e-2, the JAX
  test's.
"""

import numpy as np
import scipy.stats
import torch

from celeste_tpu_torch.likelihood import poisson_loglik
from celeste_tpu_torch.mog import convolve, eval_grid, isotropic


def test_mog_convolution_matches_fft():
    f = isotropic([0.7, 0.3], np.zeros((2, 2)), [1.5, 4.0])
    g = isotropic([0.6, 0.4], np.zeros((2, 2)), [0.8, 2.5])
    conv = convolve(f, g)
    n = 65
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2.0
    shift = torch.tensor([c, c], dtype=torch.float32)

    def grid(m):
        return eval_grid(m.shift(shift), torch.as_tensor(xx.ravel()),
                         torch.as_tensor(yy.ravel())).numpy().reshape(n, n)

    img_f, img_g, img_conv = grid(f), grid(g), grid(conv)
    fft_conv = np.real(np.fft.ifft2(np.fft.fft2(np.fft.ifftshift(img_f)) * np.fft.fft2(img_g)))
    np.testing.assert_allclose(img_conv, fft_conv, atol=5e-5)


def test_poisson_matches_scipy():
    rng = np.random.default_rng(0)
    lam = rng.uniform(1.0, 50.0, size=(7, 9))
    counts = rng.poisson(lam).astype(np.float64)
    want = scipy.stats.poisson.logpmf(counts, lam).sum()
    got = float(poisson_loglik(torch.as_tensor(lam, dtype=torch.float32),
                               torch.as_tensor(counts, dtype=torch.float32), normalized=True))
    assert abs(got - want) < 1e-2
