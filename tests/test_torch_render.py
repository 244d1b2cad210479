"""The stamp render kernel's plain version (``_render_torch``, K7) and the
posterior-predictive check (``celeste_tpu_torch.ppc``) on the CPU, against
the JAX package.

- ``_render_torch`` against JAX ``mog_field_render`` in interpret mode over
  the whole lane-padded [B, PIX_PAD] array (the padded lanes hold px = py =
  0 and sky = 1, so both render the sources at pixel (0, 0) there), star
  and galaxy planes: rtol 1e-5, atol 1e-3 (tests/test_pallas_kernel.py's
  render gate; sums of up to 48 terms on a sky of 150).
- the same on ``random_render_problem``, the problem K7's card tests use;
  K7's launch geometry (``k7_geometry``) stores every pixel once.
- ``ppc_lambda_draws`` against JAX's on the same samples and seed (the same
  host draw picks the same rows): the same gate.
- tests/test_ppc.py's calibrated and missing-source cases on a port MH
  posterior: p in (0.02, 0.98) and |z| < 6 with |mean z| < 0.3; with the
  second source's log-flux at -8, p < 0.02 and max |z| > 8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu.kernels import mog_field as jmf
from celeste_tpu.parallel import CrowdedScene as JScene
from celeste_tpu.ppc import ppc_lambda_draws as j_ppc_lambda_draws

from celeste_tpu_torch.inference import mh_init, mh_kernel, run_chains_ensemble
from celeste_tpu_torch.kernels import mog_field as tmf
from celeste_tpu_torch.parallel.crowded import CrowdedScene, make_crowded_logdensity
from celeste_tpu_torch.ppc import ppc_chi2_pvalue, ppc_lambda_draws, ppc_pixel_zscores

from torch_port_helpers import (  # noqa: F401 (autouse fixture)
    one_torch_thread, port_stamp, source_base_vector, source_vecs,
)

LAM_TOL = dict(rtol=1e-5, atol=1e-3)
COSD = np.cos(np.deg2rad(10.0))


@pytest.fixture(scope="module")
def scenes():
    star = make_synthetic_stamp([star_source(u=(30.0001, 9.9999), flux_r=25.0)],
                                shape=(25, 25), bands=(2,), seed=3)
    gal = make_synthetic_stamp([galaxy_source(u=(30.0, 10.0), flux_r=60.0)],
                               shape=(25, 25), bands=(2,), seed=5)
    return {"star": star, "galaxy": gal}


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_plain_render_matches_jax_over_the_padded_array(scenes, kind):
    jstamp = scenes[kind].stamps[0]
    vecs = source_vecs(scenes[kind], kind, 11, 0.05, seed=1)
    jplanes = jax.vmap(lambda v: jmf._field_planes(v, jstamp, 2, kind, 5))(jnp.asarray(vecs))
    jpd = jmf.stamp_pixel_data(jstamp)
    want = np.asarray(jmf.mog_field_render(*jplanes, jpd, interpret=True))
    planes = [torch.as_tensor(np.array(p)) for p in jplanes]
    px, py, _, sky, _ = (torch.as_tensor(np.array(p)) for p in jpd)
    got = tmf._render_torch(*planes, px, py, sky).numpy()
    assert got.shape == want.shape == (11, 640)
    np.testing.assert_allclose(got, want, **LAM_TOL)


def test_render_entry_point_on_the_cpu(scenes):
    tstamp = port_stamp(scenes["galaxy"].stamps[0])
    vecs = torch.as_tensor(source_vecs(scenes["galaxy"], "galaxy", 6, 0.05, seed=2))
    planes = [t.contiguous() for t in tmf._field_planes(vecs, tstamp, 2, "galaxy", 5)]
    pd = tmf.stamp_pixel_data(tstamp)
    planes[0][::2] = 0.0                    # zero-amplitude rows render exactly the sky
    before = tmf.launch_counts()
    lam = tmf.mog_field_render(*planes, pd)
    assert tmf.launch_counts() == before
    assert torch.equal(lam, tmf._render_torch(*planes, pd[0], pd[1], pd[3]))
    assert torch.equal(lam[::2], pd[3].expand(3, -1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmf.render_cuda(*planes, pd[0], pd[1], pd[3])
    meta = [torch.empty(t.shape, device="meta") for t in planes]
    with pytest.raises(ValueError, match="no implementation"):
        tmf.mog_field_render(*meta, pd)


@pytest.mark.parametrize("b,c,h,w", [(10, 5, 25, 25), (4, 9, 26, 31)])
def test_plain_render_on_a_random_problem_matches_jax(b, c, h, w):
    """``random_render_problem`` (rotated Gaussians spread over the stamp,
    every 9th chain at zero amplitude), the problem K7's card tests use,
    through JAX's render in interpret mode and the port's plain version."""
    planes, pix = tmf.random_render_problem(b, c, h, w, seed=b + c)
    px, py, sky = pix
    assert px.shape == (1, -(-h * w // 128) * 128)
    assert np.all(px[0, h * w:] == 0) and np.all(sky[0, h * w:] == 1)
    pd = tuple(jnp.asarray(a) for a in (px, py, sky, sky, sky))
    want = np.asarray(jmf.mog_field_render(*(jnp.asarray(a) for a in planes), pd,
                                           interpret=True))
    got = tmf._render_torch(*(torch.as_tensor(a) for a in planes),
                            *(torch.as_tensor(a) for a in pix)).numpy()
    np.testing.assert_allclose(got, want, **LAM_TOL)
    assert np.array_equal(got[::9], np.broadcast_to(sky, got[::9].shape))


@pytest.mark.parametrize("b", [1, 9, 32, 64, 1024, 65536])
@pytest.mark.parametrize("n_pix", [640, 1024, 6144, 16384])
def test_k7_geometry_covers_every_pixel_once(b, n_pix):
    """K7's (CB, T): 32 and 64 chains fill at least one block per SM of the
    H100 with pixel tiles, 65536 chains keep 8 chains per block (one staged
    chunk serves 8), and a chain's T * 8 / CB warps store every pixel
    exactly once (the kernel's slicing, ``k1_pixel_slices``)."""
    cb, t = tmf.k7_geometry(b, n_pix)
    assert cb in (1, 2, 4, 8) and 1 <= t <= -(-n_pix // 32)
    if b >= 32:
        assert -(-b // cb) * t >= tmf.N_SM
    if b == 65536:
        assert (cb, t) == (8, 1)
    slices = tmf.k1_pixel_slices(n_pix, cb, t)
    assert len(slices) == t * tmf.WARPS // cb
    covered = np.sort(np.concatenate([np.asarray(s, dtype=np.int64) for s in slices]))
    assert np.array_equal(covered, np.arange(n_pix))


@pytest.mark.parametrize("kinds", [("star", "star"), ("galaxy",)])
def test_ppc_lambda_draws_matches_jax(scenes, kinds):
    sd = scenes["galaxy" if kinds == ("galaxy",) else "star"]
    jstamp = sd.stamps[0]
    # each source's truth with its r-band flux slot only (n_bands=1)
    base = np.concatenate([np.delete(source_base_vector(sd, k), [2, 3, 5, 6]) for k in kinds])
    rng = np.random.default_rng(4)
    samples = (base + 0.02 * rng.normal(size=(3, 10, base.size))).astype(np.float32)
    want = j_ppc_lambda_draws(JScene(kinds=kinds, n_bands=1), samples, jstamp, band=0,
                              n_draws=12, seed=7)
    got = ppc_lambda_draws(CrowdedScene(kinds=kinds, n_bands=1), samples, port_stamp(jstamp),
                           band=0, n_draws=12, seed=7)
    assert got.shape == want.shape == (12, 25, 25)
    np.testing.assert_allclose(got, np.asarray(want), **LAM_TOL)


@pytest.fixture(scope="module")
def fitted_scene():
    """tests/test_ppc.py's two-star scene and an MH posterior of the port."""
    srcs = [
        star_source(u=(30.0 - 2.0 / 3600 / COSD, 10.0), flux_r=40.0),
        star_source(u=(30.0 + 2.0 / 3600 / COSD, 10.0 + 1.0 / 3600), flux_r=28.0),
    ]
    sd = make_synthetic_stamp(srcs, shape=(25, 25), bands=(2,), seed=5)
    stamp = port_stamp(sd.stamps[0])
    scene = CrowdedScene(kinds=("star", "star"), n_bands=1)
    logd = make_crowded_logdensity(scene, [stamp], bands=[0])
    vec = np.concatenate([np.concatenate([sd.wcs.equa2duas(s["u"]), [np.log(s["flux"][2])]])
                          for s in srcs]).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.as_tensor(vec)[None] + 0.01 * torch.randn((16, 6), generator=gen)
    with torch.no_grad():
        kern = mh_kernel(logd, step_scales=torch.full((6,), 0.01))
        samples, _, _ = run_chains_ensemble(gen, kern, mh_init(x0, logd), n_steps=400)
    return scene, stamp, samples[:, 100:].numpy()


def test_ppc_calibrated_model_passes(fitted_scene):
    scene, stamp, samples = fitted_scene
    lam = ppc_lambda_draws(scene, samples, stamp, band=0, n_draws=24)
    assert lam.shape == (24, 25, 25) and np.isfinite(lam).all()
    p, d_obs, d_rep = ppc_chi2_pvalue(lam, stamp.counts.numpy(), mask=stamp.mask.numpy())
    assert 0.02 < p < 0.98, (p, d_obs.mean(), d_rep.mean())
    z = ppc_pixel_zscores(lam, stamp.counts.numpy())
    assert np.abs(z).max() < 6.0
    assert abs(z.mean()) < 0.3


def test_ppc_flags_missing_source(fitted_scene):
    scene, stamp, samples = fitted_scene
    wrong = samples.copy()
    wrong[..., 5] = -8.0                    # second source's log-flux -> ~0
    lam = ppc_lambda_draws(scene, wrong, stamp, band=0, n_draws=24)
    p, _, _ = ppc_chi2_pvalue(lam, stamp.counts.numpy(), mask=stamp.mask.numpy())
    assert p < 0.02, p
    assert np.abs(ppc_pixel_zscores(lam, stamp.counts.numpy())).max() > 8.0
