"""The port's stamp kernel module (``celeste_tpu_torch.kernels.mog_field``)
on the CPU, where it runs the kernels' plain PyTorch versions, against the
JAX package: ``mog_field_loglik(impl="pallas")`` in interpret mode (as
tests/test_pallas_kernel.py runs it) and ``impl="jnp"``, on identical
planes and pixels.

Tolerances are those of the JAX package's kernel tests
(tests/test_pallas_kernel.py): values rtol 2e-6 with atol 0.5 for stars and
1.0 for galaxies (sums of ~640 fp32 terms of magnitude ~1e3 taken in
another order); gradients rtol 5e-4, atol 5e-2.  The kernels themselves are
held against the same plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu.kernels import mog_field as jmf

from celeste_tpu_torch.kernels import mog_field as tmf

from torch_port_helpers import one_torch_thread, port_stamp, source_vecs  # noqa: F401 (autouse fixture)

TOL = {"star": dict(rtol=2e-6, atol=0.5), "galaxy": dict(rtol=2e-6, atol=1.0)}
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)
N_CHAINS = {"star": 37, "galaxy": 13}   # ragged: not a multiple of any tile


@pytest.fixture(scope="module")
def scenes():
    star = make_synthetic_stamp([star_source(u=(30.0001, 9.9999), flux_r=25.0)],
                                shape=(25, 25), bands=(2,), seed=3)
    gal = make_synthetic_stamp([galaxy_source(u=(30.0, 10.0), flux_r=60.0)],
                               shape=(25, 25), bands=(2,), seed=5)
    return {"star": star, "galaxy": gal}


def _inputs(scenes, kind):
    scene = scenes[kind]
    vecs = source_vecs(scene, kind, N_CHAINS[kind], 0.05, seed=0)
    return scene.stamps[0], port_stamp(scene.stamps[0]), vecs


def test_stamp_pixel_data_matches_jax(scenes):
    jstamp, tstamp, _ = _inputs(scenes, "star")
    for got, want in zip(tmf.stamp_pixel_data(tstamp), jmf.stamp_pixel_data(jstamp)):
        assert got.shape == (1, 640)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_field_planes_match_jax(scenes, kind):
    jstamp, tstamp, vecs = _inputs(scenes, kind)
    want = jax.vmap(lambda v: jmf._field_planes(v, jstamp, 2, kind, 5))(jnp.asarray(vecs))
    got = tmf._field_planes(torch.as_tensor(vecs), tstamp, 2, kind, 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
@pytest.mark.parametrize("centered", [False, True])
def test_loglik_matches_jax_pallas_and_jnp(scenes, kind, centered):
    jstamp, tstamp, vecs = _inputs(scenes, kind)
    jplanes = jax.vmap(lambda v: jmf._field_planes(v, jstamp, 2, kind, 5))(jnp.asarray(vecs))
    jpd = jmf.stamp_pixel_data(jstamp)
    # one set of planes and pixels, handed to both packages as numpy
    planes = [torch.as_tensor(np.array(p)) for p in jplanes]
    pd = [torch.as_tensor(np.array(p)) for p in jpd]
    got = tmf._loglik_torch(*planes, *pd, centered=centered).numpy()
    want_pallas = jmf.mog_field_loglik(*jplanes, jpd, impl="pallas", interpret=True,
                                       centered=centered)
    want_jnp = jmf.mog_field_loglik(*jplanes, jpd, impl="jnp", centered=centered)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL[kind])
    np.testing.assert_allclose(got, np.asarray(want_jnp), **TOL[kind])
    # the whole port path: vectors -> planes -> plain loglik
    e2e = tmf.batched_stamp_loglik(torch.as_tensor(vecs), tstamp, band=2, kind=kind,
                                   n_bands=5, centered=centered).numpy()
    np.testing.assert_allclose(e2e, np.asarray(want_pallas), **TOL[kind])


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_gradient_matches_jax_grad(scenes, kind):
    jstamp, tstamp, vecs = _inputs(scenes, kind)
    vecs = vecs[:5]
    want = jax.grad(lambda v: jnp.sum(jmf.batched_stamp_loglik(
        v, jstamp, band=2, kind=kind, impl="pallas")))(jnp.asarray(vecs))
    x = torch.as_tensor(vecs).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tmf.batched_stamp_loglik(x, tstamp, band=2, kind=kind, n_bands=5).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def _planes(scenes, kind):
    _, tstamp, vecs = _inputs(scenes, kind)
    planes = [t.contiguous() for t in tmf._field_planes(torch.as_tensor(vecs), tstamp, 2,
                                                         kind, 5)]
    return planes, tmf.stamp_pixel_data(tstamp)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_plain_backward_matches_autograd(scenes, kind):
    planes, pd = _planes(scenes, kind)
    mask = pd[4].clone()
    mask[0, ::7] = 0.0
    pd = (*pd[:4], mask)
    g = torch.as_tensor(np.random.default_rng(1).normal(size=N_CHAINS[kind]), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    want = torch.autograd.grad(tmf._loglik_torch(*leaves, *pd), leaves, g)
    got = tmf._loglik_bwd_torch(*planes, *pd, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)


def test_zero_amplitude_component_gives_finite_gradients(scenes):
    planes, pd = _planes(scenes, "star")
    planes[0][:, 1] = 0.0
    g = torch.ones(planes[0].shape[0])
    hand = tmf._loglik_bwd_torch(*planes, *pd, g)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    auto = torch.autograd.grad(tmf._loglik_torch(*leaves, *pd), leaves, g)
    for a, w in zip(hand, auto):
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(w).all())
        torch.testing.assert_close(a, w, **GRAD_TOL)


@pytest.mark.parametrize("centered", [False, True])
def test_fully_masked_stamp_is_exactly_zero(scenes, centered):
    planes, pd = _planes(scenes, "star")
    out = tmf.mog_field_loglik(*planes, (*pd[:4], torch.zeros_like(pd[4])), centered=centered)
    assert bool((out == 0).all())


def test_cpu_tensors_take_the_plain_version(scenes):
    planes, pd = _planes(scenes, "star")
    before = tmf.launch_counts()
    got = tmf.mog_field_loglik(*planes, pd)
    assert tmf.launch_counts() == before
    torch.testing.assert_close(got, tmf._loglik_torch(*planes, *pd), rtol=0, atol=0)


def test_no_silent_fallback(scenes):
    planes, pd = _planes(scenes, "star")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmf.loglik_fwd_cuda(*planes, *pd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmf.loglik_bwd_cuda(*planes, *pd, torch.ones(planes[0].shape[0]))
    meta = [torch.empty(t.shape, device="meta") for t in planes]
    with pytest.raises(ValueError, match="no implementation"):
        tmf.mog_field_loglik(*meta, pd)


LOG2E = 1.4426950408889634


def _moment_cotangents_k1(amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, g):
    """K1-bwd of ``csrc/mog_field.cu`` in moment form, in torch: lambda and
    g_lam from the base-2 form the kernel stages, the six pixel moments of
    ge = g_lam e per (chain, component), and the kernel's epilogue."""
    dx = px[:, None, :] - mx[..., None]                                  # [B, C, P]
    dy = py[:, None, :] - my[..., None]
    dxx, dxy, dyy = dx * dx, dx * dy, dy * dy
    e = torch.exp2((-0.5 * LOG2E * pa[..., None]) * dxx + (-LOG2E * pb[..., None]) * dxy
                   + (-0.5 * LOG2E * pc[..., None]) * dyy)
    lam = sky + torch.sum(amp[..., None] * e, dim=1)
    active = (lam > tmf.LAMBDA_MIN).to(lam.dtype)
    g_lam = (g[:, None] * mask) * (counts / torch.clamp(lam, min=tmf.LAMBDA_MIN) - 1.0) * active
    ge = g_lam[:, None, :] * e
    s0, sx, sy, sxx, sxy, syy = (torch.sum(ge * m, -1) for m in (1.0, dx, dy, dxx, dxy, dyy))
    return (s0, amp * (pa * sx + pb * sy), amp * (pb * sx + pc * sy),
            -0.5 * amp * sxx, -amp * sxy, -0.5 * amp * syy)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_moment_form_backward_matches_plain_k1(scenes, kind, seed):
    """K1-bwd's algebra (base-2 exponent, moments, epilogue) against the
    plain backward at the gradient tolerance, rtol 5e-4, atol 5e-2, on a
    holed mask with one zero-amplitude component in five chains."""
    _, tstamp, _ = _inputs(scenes, kind)
    vecs = source_vecs(scenes[kind], kind, N_CHAINS[kind], 0.05, seed=seed)
    planes = [t.contiguous() for t in tmf._field_planes(torch.as_tensor(vecs), tstamp, 2,
                                                         kind, 5)]
    planes[0][::5, 0] = 0.0
    px, py, counts, sky, mask = tmf.stamp_pixel_data(tstamp)
    mask = mask.clone()
    mask[0, ::7] = 0.0
    g = torch.as_tensor(np.random.default_rng(seed).normal(size=N_CHAINS[kind]),
                        dtype=torch.float32)
    pix = (px, py, counts, sky, mask)
    got = _moment_cotangents_k1(*planes, *pix, g)
    want = tmf._loglik_bwd_torch(*planes, *pix, g)
    for name, a, w in zip("amp mx my pa pb pc".split(), got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("b", [1, 9, 32, 64, 65536])
@pytest.mark.parametrize("n_pix", [640, 1024, 6144, 16384])
def test_k1_geometry_covers_every_pixel_once(b, n_pix):
    """K1's (CB, T): the cluster stays within the portable 8 blocks, 32
    chains fill at least one block per SM of the H100, and the chain's
    T * 8 / CB warps take every pixel exactly once."""
    cb, t = tmf.k1_geometry(b, n_pix)
    assert cb in (1, 2, 4, 8) and 1 <= t <= tmf.MAX_CLUSTER
    n_blocks = -(-b // cb) * t
    if b >= 32:
        assert n_blocks >= tmf.N_SM
    if b == 65536:
        assert (cb, t) == (8, 1)
    slices = tmf.k1_pixel_slices(n_pix, cb, t)
    assert len(slices) == t * tmf.WARPS // cb
    covered = np.sort(np.concatenate([np.asarray(s, dtype=np.int64) for s in slices]))
    assert np.array_equal(covered, np.arange(n_pix))


@pytest.fixture(scope="module")
def galaxy_96():
    return make_synthetic_stamp([galaxy_source(u=(30.0, 10.0), flux_r=60.0)],
                                shape=(96, 96), bands=(2,), seed=5)


@pytest.mark.parametrize("centered", [False, True])
def test_plain_loglik_and_gradient_on_a_96x96_galaxy_match_jax(galaxy_96, centered):
    """A 96x96 stamp (9216 pixels, beyond a block's shared memory): the plain
    ``mog_field_loglik`` and its autograd gradient against JAX's dense
    ``_loglik_jnp`` and ``jax.grad`` of it, at the galaxy tolerances."""
    jstamp = galaxy_96.stamps[0]
    vecs = source_vecs(galaxy_96, "galaxy", 4, 0.05, seed=4)
    jplanes = jax.vmap(lambda v: jmf._field_planes(v, jstamp, 2, "galaxy", 5))(jnp.asarray(vecs))
    jpd = jmf.stamp_pixel_data(jstamp)
    planes = [torch.as_tensor(np.array(p)).requires_grad_(True) for p in jplanes]
    pd = tuple(torch.as_tensor(np.array(p)) for p in jpd)
    assert pd[0].shape == (1, 9216)
    got = tmf.mog_field_loglik(*planes, pd, centered=centered)
    want = jmf._loglik_jnp(*jplanes, *jpd, centered=centered)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL["galaxy"])
    g = np.random.default_rng(6).normal(size=4).astype(np.float32)
    got_g = torch.autograd.grad(got, planes, torch.as_tensor(g))
    want_g = jax.grad(lambda ps: jnp.sum(jmf._loglik_jnp(*ps, *jpd, centered=centered)
                                         * jnp.asarray(g)))(tuple(jplanes))
    for name, a, w in zip("amp mx my pa pb pc".split(), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)
