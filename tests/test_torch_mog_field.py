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
