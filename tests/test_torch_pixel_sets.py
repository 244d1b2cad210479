"""The stamp kernels' pixel-set mode (``kernels/mog_field.py``: [S, P]
pixel arrays, row b reading set b // (B / S)) in its plain version on the
CPU, against the kernels' plain versions row by row and against the JAX
package's field path, which vmaps ``_loglik_jnp`` over per-candidate
cutouts (``celeste_tpu/field.py:459-468``) and renders each cutout's
lambda; JAX's render runs as its own tests run it, in interpret mode.

Tolerances are those of the JAX package's kernel tests
(tests/test_pallas_kernel.py): values rtol 2e-6 with atol 0.5 (1.0 for a
galaxy's 48 components), gradients rtol 5e-4 with atol 5e-2, lambda rtol
1e-5 with atol 1e-3.  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.kernels import mog_field as jmf

from celeste_tpu_torch.kernels import mog_field as tmf

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=2e-6, atol=1.0)
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)
LAM_TOL = dict(rtol=1e-5, atol=1e-3)
# (sets, rows per set, components, cutout side): candidate cutouts (R = 1:
# detection; R = 2: the classify batch) and group cutouts at R = 4
CASES = [(5, 1, 3, 24), (4, 2, 48, 24), (3, 4, 96, 16)]


def _problem(s, r, c, side):
    planes, sets = tmf.random_pixel_set_problem(s, r, c, side, seed=10 * s + r)
    return [torch.as_tensor(a) for a in planes], [torch.as_tensor(a) for a in sets]


def _row_set(sets, b, r):
    """Row b's own set as the [1, P] pixel data of the stamp mode."""
    return tuple(t[b // r:b // r + 1] for t in sets)


@pytest.mark.parametrize("s,r,c,side", CASES)
@pytest.mark.parametrize("centered", [False, True])
def test_loglik_equals_the_stamp_mode_row_by_row(s, r, c, side, centered):
    planes, sets = _problem(s, r, c, side)
    got = tmf.mog_field_loglik(*planes, sets, centered=centered)
    assert got.shape == (s * r,)
    for b in range(s * r):
        want = tmf._loglik_torch(*(p[b:b + 1] for p in planes), *_row_set(sets, b, r), centered)
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("s,r,c,side", CASES)
def test_loglik_and_gradient_match_jax_vmapped_over_cutouts(s, r, c, side):
    """The port's plain pixel-set mode and its autograd gradient against
    JAX's field path: ``_loglik_jnp`` of one row on its own cutout, vmapped
    over rows, and ``jax.grad`` through it (centered, as the group sampler
    runs it)."""
    planes, sets = _problem(s, r, c, side)
    set_of_row = np.arange(s * r) // r

    def one(row_planes, pxi, pyi, ci, ski, mi):
        return jmf._loglik_jnp(*(p[None] for p in row_planes), pxi[None], pyi[None],
                               ci[None], ski[None], mi[None], centered=True)[0]

    j_sets = [jnp.asarray(t.numpy()[set_of_row]) for t in sets]
    j_planes = tuple(jnp.asarray(p.numpy()) for p in planes)
    want = jax.vmap(one)(j_planes, *j_sets)
    want_g = jax.vmap(jax.grad(one))(j_planes, *j_sets)
    leaves = [p.clone().requires_grad_(True) for p in planes]
    got = tmf.mog_field_loglik(*leaves, sets, centered=True)
    got_g = torch.autograd.grad(got.sum(), leaves)
    torch.testing.assert_close(got.detach(), torch.as_tensor(np.array(want)), **TOL)
    for g_t, g_j in zip(got_g, want_g):
        torch.testing.assert_close(g_t, torch.as_tensor(np.array(g_j)), **GRAD_TOL)
    # the kernel's hand backward, given the sets expanded to rows
    hand = tmf._loglik_bwd_torch(*planes, *tmf.rows_of_sets(tuple(sets), s * r),
                                 torch.ones(s * r))
    for g_h, g_a in zip(hand, got_g):
        torch.testing.assert_close(g_h, g_a, **GRAD_TOL)


@pytest.mark.parametrize("s,r,c,side", CASES)
def test_render_matches_jax_per_cutout(s, r, c, side):
    """lambda of every row on its own cutout, padded lanes included (they
    render as the sky, 1), against JAX's render kernel in interpret mode
    on a set's rows (the first and the last set); with a zero sky, the
    sky-free lambda the field pipeline subtracts and scatters."""
    planes, sets = _problem(s, r, c, side)
    for sky, checked in ((sets[3], (0,)), (torch.zeros_like(sets[3]), (0, s - 1))):
        pd = (sets[0], sets[1], sets[2], sky, sets[4])
        got = tmf.mog_field_render(*planes, pd)
        for k in checked:
            rows = slice(k * r, (k + 1) * r)
            want = jmf.mog_field_render(*(jnp.asarray(p[rows].numpy()) for p in planes),
                                        tuple(jnp.asarray(t[k:k + 1].numpy()) for t in pd),
                                        interpret=True)
            torch.testing.assert_close(got[rows], torch.as_tensor(np.array(want)), **LAM_TOL)
        pad = slice(side * side, None)
        assert bool((got[:, pad] == sky[0, -1]).all())


def test_padding_adds_nothing():
    """``pad_pixel_sets`` pads each set to a multiple of 128 lanes with
    x = y = 0, counts 0, sky 1 and mask 0: the padded sets give the
    unpadded sets' log-likelihood exactly, centered or not, and a finite
    gradient."""
    planes, sets = _problem(3, 2, 48, 24)
    n = 24 * 24
    raw = [t[:, :n] for t in sets]
    padded = tmf.pad_pixel_sets(*raw)
    assert padded[0].shape == (3, 640)
    for t, ref in zip(padded, sets):
        assert torch.equal(t, ref)
    for centered in (False, True):
        torch.testing.assert_close(tmf.mog_field_loglik(*planes, padded, centered=centered),
                                   tmf.mog_field_loglik(*planes, raw, centered=centered),
                                   rtol=1e-6, atol=1e-3)
    leaves = [p.clone().requires_grad_(True) for p in planes]
    grads = torch.autograd.grad(tmf.mog_field_loglik(*leaves, padded, centered=True).sum(),
                                leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_one_set_is_the_stamp_mode():
    """[1, P] pixel data keep the stamp mode: broadcast to every row, the
    same bits as before the mode existed."""
    planes, sets = _problem(1, 6, 3, 24)
    got = tmf.mog_field_loglik(*planes, sets)
    assert torch.equal(got, tmf._loglik_torch(*planes, *sets))
    assert tmf.rows_of_sets(tuple(sets), 6) == tuple(sets)


def test_geometry_keeps_a_blocks_chains_in_one_set():
    """k1_geometry and k7_geometry with S sets: CB divides the rows per set
    (1 at R = 1 and 3, 2 at R = 2, 8 at R = 32), and with one set the
    stamp mode's geometry is unchanged."""
    for b, p in ((65536, 640), (32, 640), (64, 1024), (9, 640), (1024, 6144)):
        assert tmf.k1_geometry(b, p, 1) == tmf.k1_geometry(b, p)
        assert tmf.k7_geometry(b, p, 1) == tmf.k7_geometry(b, p)
    for b, p, s in ((16, 640, 16), (32, 640, 16), (96, 640, 32), (128, 2304, 4),
                    (4096, 2304, 128), (424, 1024, 53), (6, 640, 2)):
        r = b // s
        for geometry in (tmf.k1_geometry, tmf.k7_geometry):
            cb, t = geometry(b, p, s)
            assert r % cb == 0 and cb in (1, 2, 4, 8) and t >= 1, (b, p, s, cb, t)
    assert tmf.k1_geometry(4096, 2304, 128)[0] == 8


def test_rows_must_split_into_the_sets():
    planes, sets = _problem(3, 2, 3, 24)
    with pytest.raises(ValueError, match="pixel sets"):
        tmf.mog_field_loglik(*(p[:5] for p in planes), sets)
