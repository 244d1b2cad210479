"""The port's separable kernel module (``celeste_tpu_torch.kernels.mog_field_sep``,
K8) on the CPU, where it runs the kernel's plain PyTorch versions, against
the JAX package: ``mog_field_loglik_isotropic`` in interpret mode and its
jnp path, and ``batched_stamp_loglik(impl="pallas_sep")``, on the scene of
tests/test_sep_kernel.py.

Tolerances are those of tests/test_sep_kernel.py: values rtol 2e-6, atol
0.5 (the separable lambda is a product of two exponentials, the general
one an exponential of a sum: about an ulp per term over 625 pixels);
gradients rtol 5e-4, atol 5e-2.  The plain backward against torch autograd
at the gradient gate.  The kernels themselves are held against the same
plain versions on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.kernels import batched_stamp_loglik as j_batched
from celeste_tpu.kernels import mog_field_sep as jsep
from celeste_tpu.model.stamp import Stamp as JStamp
from celeste_tpu.mog import MoG2D as JMoG2D

from celeste_tpu_torch.kernels import mog_field as tmf
from celeste_tpu_torch.kernels import mog_field_sep as tsep
from celeste_tpu_torch.mog import MoG2D

from torch_port_helpers import one_torch_thread, port_stamp, source_vecs  # noqa: F401 (autouse fixture)

TOL = dict(rtol=2e-6, atol=0.5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)
N = 9


@pytest.fixture(scope="module")
def scene():
    src = star_source(u=(30.0001, 9.9999), flux_r=25.0)
    return make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=3)


def _inputs(scene, n=N, seed=0):
    jstamp = scene.stamps[0]
    return jstamp, port_stamp(jstamp), source_vecs(scene, "star", n, 0.05, seed=seed)


def _jax_planes(jstamp, vecs):
    return jax.vmap(lambda v: jsep.star_planes_isotropic(v, jstamp, 2, 5))(jnp.asarray(vecs))


def _holed(mask):
    mask = np.array(mask)
    mask[:, ::7] = 0.0
    return mask


def test_stamp_pixel_data_2d_drops_the_lane_padding(scene):
    jstamp, tstamp, _ = _inputs(scene)
    got = tsep.stamp_pixel_data_2d(tstamp)
    want = jsep.stamp_pixel_data_2d(jstamp)
    assert [tuple(t.shape) for t in got] == [(1, 25), (1, 25), (25, 25), (25, 25), (25, 25)]
    assert np.array_equal(got[0].numpy(), np.asarray(want[0])[:, :25])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1])[:, :25])
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g.numpy(), np.asarray(w)[:, :25])
    # the padding the port drops is masked out in JAX: it contributes exactly 0
    assert not np.asarray(want[4])[:, 25:].any()


def test_star_planes_match_jax(scene):
    jstamp, tstamp, vecs = _inputs(scene)
    got = tsep.star_planes_isotropic(torch.as_tensor(vecs), tstamp, 2, 5)
    for g, w in zip(got, _jax_planes(jstamp, vecs)):
        assert tuple(g.shape) == (N, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("holed", [False, True])
def test_plain_forward_matches_jax(scene, centered, holed):
    jstamp, tstamp, vecs = _inputs(scene)
    jplanes = _jax_planes(jstamp, vecs)
    jpd = list(jsep.stamp_pixel_data_2d(jstamp))
    tpd = list(tsep.stamp_pixel_data_2d(tstamp))
    if holed:
        jpd[4] = jnp.asarray(_holed(jpd[4]))
        tpd[4] = torch.as_tensor(_holed(tpd[4].numpy()))
    planes = [torch.as_tensor(np.array(p)) for p in jplanes]
    got = tsep._sep_loglik_torch(*planes, *tpd, centered=centered).numpy()
    for impl in ("pallas", "jnp"):
        want = jsep.mog_field_loglik_isotropic(*jplanes, tuple(jpd), impl=impl, interpret=True,
                                               centered=centered)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_dispatch_matches_jax_pallas_sep_values_and_gradients(scene):
    jstamp, tstamp, vecs = _inputs(scene, n=4)
    want = j_batched(jnp.asarray(vecs), jstamp, band=2, kind="star", impl="pallas_sep")
    want_g = jax.grad(lambda v: jnp.sum(j_batched(v, jstamp, band=2, kind="star",
                                                  impl="pallas_sep")))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    got = tmf.batched_stamp_loglik(x, tstamp, band=2, kind="star", n_bands=5, impl="sep")
    (got_g,) = torch.autograd.grad(got.sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("centered", [False, True])
def test_sep_agrees_with_the_general_kernel(scene, centered):
    _, tstamp, vecs = _inputs(scene)
    x = torch.as_tensor(vecs).requires_grad_(True)
    out = {}
    for impl in ("sep", "general"):
        val = tmf.batched_stamp_loglik(x, tstamp, band=2, kind="star", n_bands=5,
                                       centered=centered, impl=impl)
        (g,) = torch.autograd.grad(val.sum(), x)
        out[impl] = (val.detach(), g)
    torch.testing.assert_close(out["sep"][0], out["general"][0], **TOL)
    torch.testing.assert_close(out["sep"][1], out["general"][1], **GRAD_TOL)


def _plain_planes(scene, n=N):
    _, tstamp, vecs = _inputs(scene, n=n)
    planes = [t.contiguous() for t in tsep.star_planes_isotropic(torch.as_tensor(vecs), tstamp,
                                                                 2, 5)]
    return planes, tsep.stamp_pixel_data_2d(tstamp)


@pytest.mark.parametrize("zero_amp", [False, True])
def test_plain_backward_matches_autograd(scene, zero_amp):
    planes, pd = _plain_planes(scene)
    pd = (*pd[:4], torch.as_tensor(_holed(pd[4].numpy())))
    if zero_amp:
        planes[0][:, 1] = 0.0
    g = torch.as_tensor(np.random.default_rng(1).normal(size=N), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    want = torch.autograd.grad(tsep._sep_loglik_torch(*leaves, *pd), leaves, g)
    got = tsep._sep_loglik_bwd_torch(*planes, *pd, g)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, **GRAD_TOL)


def _skewed(cov, kind):
    """A non-isotropic copy of a PSF covariance stack: an off-diagonal term,
    or unequal axes."""
    cov = np.array(cov)
    if kind == "off-diagonal":
        cov[:, 0, 1] = cov[:, 1, 0] = 1e-3 * cov[:, 0, 0]
    else:
        cov[:, 1, 1] *= 1.3
    return cov


@pytest.mark.parametrize("kind", ["off-diagonal", "unequal axes"])
def test_psf_is_isotropic_matches_jax(scene, kind):
    jpsf = scene.stamps[0].psf
    tpsf = port_stamp(scene.stamps[0]).psf
    assert jsep.psf_is_isotropic(jpsf) and tsep.psf_is_isotropic(tpsf)
    cov = _skewed(jpsf.cov, kind)
    assert not jsep.psf_is_isotropic(JMoG2D(jpsf.w, jpsf.mu, jnp.asarray(cov)))
    assert not tsep.psf_is_isotropic(MoG2D(tpsf.w, tpsf.mu, torch.as_tensor(cov)))


def test_non_isotropic_psf_goes_to_the_general_kernel(scene):
    jstamp, tstamp, vecs = _inputs(scene, n=5)
    cov = _skewed(jstamp.psf.cov, "unequal axes")
    jstamp = JStamp(jstamp.counts, jstamp.sky, jstamp.iota, jstamp.mask,
                    JMoG2D(jstamp.psf.w, jstamp.psf.mu, jnp.asarray(cov)), jstamp.wcs_A,
                    jstamp.wcs_p0, jstamp.band)
    tstamp.psf = MoG2D(tstamp.psf.w, tstamp.psf.mu, torch.as_tensor(cov))
    x = torch.as_tensor(vecs)
    sep = tmf.batched_stamp_loglik(x, tstamp, band=2, kind="star", n_bands=5, impl="sep")
    general = tmf.batched_stamp_loglik(x, tstamp, band=2, kind="star", n_bands=5)
    assert torch.equal(sep, general)
    want = j_batched(jnp.asarray(vecs), jstamp, band=2, kind="star", impl="pallas_sep")
    np.testing.assert_allclose(sep.numpy(), np.asarray(want), **TOL)


def test_fully_masked_stamp_is_exactly_zero(scene):
    planes, pd = _plain_planes(scene)
    for centered in (False, True):
        out = tsep.mog_field_loglik_isotropic(*planes, (*pd[:4], torch.zeros_like(pd[4])),
                                              centered=centered)
        assert bool((out == 0).all())


def test_cpu_tensors_take_the_plain_version_and_nothing_falls_back(scene):
    planes, pd = _plain_planes(scene)
    before = tsep.launch_counts()
    got = tsep.mog_field_loglik_isotropic(*planes, pd)
    assert tsep.launch_counts() == before
    torch.testing.assert_close(got, tsep._sep_loglik_torch(*planes, *pd), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sep_fwd_cuda(*planes, *pd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sep_bwd_cuda(*planes, *pd, torch.ones(N))
    meta = [torch.empty(t.shape, device="meta") for t in planes]
    with pytest.raises(ValueError, match="no implementation"):
        tsep.mog_field_loglik_isotropic(*meta, pd)
    _, tstamp, vecs = _inputs(scene)
    with pytest.raises(ValueError, match="impl must be one of"):
        tmf.batched_stamp_loglik(torch.as_tensor(vecs), tstamp, band=2, impl="pallas_sep")


# ---------------------------------------------------------------------------
# the backward kernel's moment form and its walk over the pixels, away from
# the star's 25x25 stamp: W below, at and above a warp's 32 columns and
# beyond three column blocks, H != W, C on both sides of the kernels' C <= 4
# template, holed masks and a zero-amplitude component (random_sep_problem)
# ---------------------------------------------------------------------------

SEP_SHAPES = [(c, h, w) for w, h in ((25, 21), (32, 27), (33, 40), (100, 90))
              for c in (1, 3, 5)]


@pytest.mark.parametrize("c,h,w", SEP_SHAPES)
def test_moment_form_backward_matches_plain_and_jax(c, h, w):
    """The column sums R, Y1, Y2 and the four cotangents built from them
    (the backward kernel's algebra) against the plain backward and against
    JAX's autodiff of ``_sep_loglik_jnp``, at the gradient tolerance."""
    planes, pix, g = tsep.random_sep_problem(7, c, h, w, seed=c * 1000 + w)
    assert (planes[0] == 0).any() and (pix[4] == 0).any()
    tp = [torch.as_tensor(a) for a in planes]
    tx = [torch.as_tensor(a) for a in pix]
    got = tsep._sep_loglik_bwd_moments_torch(*tp, *tx, torch.as_tensor(g))
    plain = tsep._sep_loglik_bwd_torch(*tp, *tx, torch.as_tensor(g))
    _, vjp = jax.vjp(lambda *p: jsep._sep_loglik_jnp(*p, *map(jnp.asarray, pix)),
                     *map(jnp.asarray, planes))
    want = vjp(jnp.asarray(g))
    for name, a, p, j in zip(("amp", "cx", "cy", "iv"), got, plain, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, p, **GRAD_TOL, msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("h,w", [(25, 25), (27, 32), (40, 33), (90, 100), (128, 128),
                                 (2000, 1), (3, 5000), (0, 25)])
def test_k8_lane_walk_covers_every_pixel_once(h, w):
    """K8's walk: every pixel of the stamp exactly once, lane l only in the
    columns l, l + 32, ..., each lane's rows in order within a column, and
    bands of at most MAX_BAND_ROWS rows and BAND_PIX pixels (one row at
    least)."""
    walk = tsep.k8_lane_walk(h, w)
    assert len(walk) == 32
    covered = np.sort(np.concatenate([np.asarray(s, dtype=np.int64) for s in walk]))
    assert np.array_equal(covered, np.arange(h * w))
    for lane, pix in enumerate(walk):
        assert all(p % w % 32 == lane for p in pix)
        cols = {}
        for p in pix:
            cols.setdefault(p % w, []).append(p // w)
        assert all(rows == sorted(rows) for rows in cols.values())
    nr = tsep.k8_band_rows(h, w)
    assert 1 <= nr <= tsep.MAX_BAND_ROWS
    assert nr == 1 or nr * w <= tsep.BAND_PIX


@pytest.mark.parametrize("centered", [False, True])
def test_sep_problem_in_k1_form_is_the_same_likelihood(centered):
    """``sep_as_k1`` (how the card checks hold K8-fwd against K1 away from a
    star's stamp): K1's plain forward on it equals K8's plain forward."""
    planes, pix, _ = tsep.random_sep_problem(9, 3, 27, 33, seed=2)
    tp = [torch.as_tensor(a) for a in planes]
    tx = [torch.as_tensor(a) for a in pix]
    k1_planes, k1_pix = tsep.sep_as_k1(*tp, *tx)
    assert tuple(k1_pix[0].shape) == (1, 27 * 33)
    torch.testing.assert_close(tmf._loglik_torch(*k1_planes, *k1_pix, centered=centered),
                               tsep._sep_loglik_torch(*tp, *tx, centered=centered), **TOL)
