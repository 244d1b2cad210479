"""The port's sharded tempering ladder (``celeste_tpu_torch.parallel.
pt_sharded``) and ``run_photo_z_sharded`` on 2 and 4 gloo ranks against the
port's in-device ladder and ``run_photo_z``, on the CPU.

Every rank draws the whole ladder's random numbers from one generator
seeded alike, so the sharded ladder is the same Markov chain.  Tolerances
(tests/test_collectives.py:187, :296): ladder xs rtol 1e-5, atol 1e-5;
logps rtol 1e-4, atol 1e-4; every step's swap decisions equal; the photo-z
cold chain (``hmc_adaptive``) rtol 2e-4, atol 2e-5; the ladder with the
lockstep slice inner, whose loops end on every rank together, xs rtol
1e-5, atol 1e-5 and its swap decisions equal.
"""

import numpy as np
import pytest

from celeste_tpu_torch.parallel import launch

import torch_pt_workers as w
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def reference():
    return w.in_device()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ladder_is_the_in_device_ladder(reference, world):
    (xs, logps, accepts), vec, slice_ladder = reference
    ranks = launch(w.sharded_rank, world)
    got_xs = np.concatenate([r[0][0] for r in ranks], axis=-2)
    got_lp = np.concatenate([r[0][1] for r in ranks], axis=-1)
    np.testing.assert_allclose(got_xs, xs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lp, logps, rtol=1e-4, atol=1e-4)
    for r in ranks:
        np.testing.assert_array_equal(r[0][2], accepts)
        np.testing.assert_allclose(r[1], vec, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(r[2][2], slice_ladder[2])
    np.testing.assert_allclose(np.concatenate([r[2][0] for r in ranks], axis=-2),
                               slice_ladder[0], rtol=1e-5, atol=1e-5)
    assert accepts.any(axis=(1, 2)).sum() >= 2       # swaps happened, both parities ran
    assert accepts[0::2].any() and accepts[1::2].any()
