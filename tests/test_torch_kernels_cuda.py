"""The stamp kernels of ``celeste_tpu_torch/csrc/mog_field.cu`` and the tiled
field kernels of ``csrc/tiled_field.cu`` against their plain PyTorch
versions, on an NVIDIA GPU.

Every test here needs the card: it carries the ``cuda`` marker and skips
where CUDA is absent (decided in the ``cuda`` fixture, not at import).  The
file imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda

Tolerances are those of the JAX package's kernel tests
(tests/test_pallas_kernel.py): values rtol 2e-6 with atol 0.5 for stars and
1.0 for galaxies (sums of ~640 fp32 terms of magnitude ~1e3 in another
order); gradients rtol 5e-4, atol 5e-2.  The tiled kernels (K2, K3, K4)
take those of tests/test_tiled_field.py: values rtol 2e-6, atol 1.0;
gradients rtol 5e-4, atol 0.1 on config 5, and rtol 2e-4, atol 5e-3 on
the random-plane setup with repeated sentinel slots; lambda (K3, K5, K7)
rtol 1e-5, atol 1e-3 (sums of ~100 terms on a sky of ~150).
"""

import numpy as np
import pytest
import torch

from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu_torch.kernels import mog_field as mf
from celeste_tpu_torch.kernels import tiled_field as tf
from celeste_tpu_torch.kernels.tiled_field import random_tile_problem

pytestmark = pytest.mark.cuda

TOL = {"star": dict(rtol=2e-6, atol=0.5), "galaxy": dict(rtol=2e-6, atol=1.0)}
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda:0")


def _planes(kind, n, device, seed=0, shape=(25, 25)):
    if kind == "star":
        src = star_source(u=(30.0001, 9.9999), flux_r=25.0)
        scene = make_synthetic_stamp([src], shape=shape, bands=(2,), seed=3, device=device)
        extra = []
    else:
        src = galaxy_source(u=(30.0, 10.0), flux_r=60.0)
        scene = make_synthetic_stamp([src], shape=shape, bands=(2,), seed=5, device=device)
        t, ab = src["theta_dev"], src["ab"]
        extra = [[np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)), src["phi"]]]
    base = np.concatenate([scene.wcs.equa2duas(src["u"]), np.log(src["flux"]), *extra])
    rng = np.random.default_rng(seed)
    vecs = torch.as_tensor((base + 0.05 * rng.normal(size=(n, base.size))).astype(np.float32),
                           device=device)
    stamp = scene.stamps[0]
    planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 2, kind, 5)]
    return planes, mf.stamp_pixel_data(stamp), vecs, stamp


@pytest.mark.parametrize("kind", ["star", "galaxy"])
@pytest.mark.parametrize("centered", [False, True])
def test_forward_kernel_matches_plain(cuda, kind, centered):
    planes, pd, _, _ = _planes(kind, 1000, cuda)
    mask = pd[4].clone()
    mask[0, ::7] = 0.0
    pix = (*pd[:4], mask)
    got = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
    want = mf._loglik_torch(*planes, *pix, centered=centered)
    torch.testing.assert_close(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_backward_kernel_matches_autograd(cuda, kind):
    planes, pd, _, _ = _planes(kind, 777, cuda)
    g = torch.as_tensor(np.random.default_rng(1).normal(size=777).astype(np.float32),
                        device=cuda)
    got = mf.loglik_bwd_cuda(*planes, *pd, g)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    want = torch.autograd.grad(mf._loglik_torch(*leaves, *pd), leaves, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)


def test_zero_amplitude_gives_finite_gradients(cuda):
    planes, pd, _, _ = _planes("star", 64, cuda)
    planes[0][:, 1] = 0.0
    g = torch.ones(64, device=cuda)
    grads = mf.loglik_bwd_cuda(*planes, *pd, g)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    want = torch.autograd.grad(mf._loglik_torch(*leaves, *pd), leaves, g)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)


def test_fully_masked_stamp_is_exactly_zero(cuda):
    planes, pd, _, _ = _planes("star", 40, cuda)
    pix = (*pd[:4], torch.zeros_like(pd[4]))
    for centered in (False, True):
        out = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
        assert bool((out == 0).all())


def test_entry_point_launches_both_kernels(cuda):
    _, pd, vecs, stamp = _planes("star", 96, cuda)
    before = mf.launch_counts()
    x = vecs.clone().requires_grad_(True)
    out = mf.batched_stamp_loglik(x, stamp, band=2, kind="star", n_bands=5, pixel_data=pd)
    (gx,) = torch.autograd.grad(out.sum(), x)
    after = mf.launch_counts()
    assert after["mog_field_loglik_fwd"] == before["mog_field_loglik_fwd"] + 1
    assert after["mog_field_loglik_bwd"] == before["mog_field_loglik_bwd"] + 1
    x_cpu = vecs.cpu().requires_grad_(True)
    stamp_cpu = stamp.to("cpu")
    want = mf.batched_stamp_loglik(x_cpu, stamp_cpu, band=2, kind="star", n_bands=5)
    (gw,) = torch.autograd.grad(want.sum(), x_cpu)
    torch.testing.assert_close(out.detach().cpu(), want.detach(), **TOL["star"])
    torch.testing.assert_close(gx.cpu(), gw, **GRAD_TOL)


def test_wrapper_rejects_bad_inputs(cuda):
    planes, pd, _, _ = _planes("star", 8, cuda)
    with pytest.raises(ValueError, match="dtype"):
        mf.loglik_fwd_cuda(planes[0].double(), *planes[1:], *pd)
    with pytest.raises(ValueError, match="contiguous"):
        mf.loglik_fwd_cuda(planes[0].t().contiguous().t(), *planes[1:], *pd)
    with pytest.raises(ValueError, match="shape"):
        mf.loglik_fwd_cuda(*planes, pd[0][:, :-1], *pd[1:])
    with pytest.raises(ValueError):
        mf.loglik_fwd_cuda(planes[0], *planes[1:], pd[0].cpu(), *pd[1:])


def _force_path(monkeypatch, staged: bool):
    """Make the wrappers take the staged (or the whole-row) path at any C."""
    monkeypatch.setattr(mf, "components_staged", lambda kernel, cb, c: staged)


def test_launch_error_raises_and_does_not_leak(cuda, monkeypatch):
    """A launch the C side refuses (here the whole-row path forced at 8000
    components, more than a block's shared memory can stage at once) makes
    the wrapper raise, naming B and C, and count no launch; the next launch
    works.  Such a row takes the staged path otherwise."""
    planes, pd, _, _ = _planes("star", 8, cuda)
    wide = [p[:, :1].repeat(1, 8000).contiguous() for p in planes]
    before = mf.launch_counts()
    with monkeypatch.context() as m:
        _force_path(m, False)
        with pytest.raises(RuntimeError, match="launch failed at B=8, C=8000"):
            mf.loglik_fwd_cuda(*wide, *pd)
        with pytest.raises(RuntimeError, match="launch failed at B=8, C=8000"):
            mf.loglik_bwd_cuda(*wide, *pd, torch.ones(8, device=cuda))
    assert mf.launch_counts() == before
    out = mf.loglik_fwd_cuda(*planes, *pd)
    torch.testing.assert_close(out, mf._loglik_torch(*planes, *pd), **TOL["star"])


def _plain_fwd(planes, pix, centered, chunk=256):
    """The plain forward a chain chunk at a time (a 128x128 galaxy at
    B=4096 is 13 GB per [B, C, P] intermediate unchunked)."""
    return torch.cat([mf._loglik_torch(*(p[c0:c0 + chunk] for p in planes), *pix,
                                       centered=centered)
                      for c0 in range(0, planes[0].shape[0], chunk)])


def _check_k1(planes, pd, kind, bwd=True):
    """K1-fwd (centered both ways, full and holed masks) and, if asked,
    K1-bwd against the plain versions; each kernel twice, bitwise equal."""
    b = planes[0].shape[0]
    holed = pd[4].clone()
    holed[0, ::7] = 0.0
    for mask in (pd[4], holed):
        pix = (*pd[:4], mask)
        for centered in (False, True):
            got = mf.loglik_fwd_cuda(*planes, *pix, centered=centered)
            assert torch.equal(got, mf.loglik_fwd_cuda(*planes, *pix, centered=centered))
            torch.testing.assert_close(got, _plain_fwd(planes, pix, centered), **TOL[kind])
    if not bwd:
        return
    pix = (*pd[:4], holed)
    g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32),
                        device=planes[0].device)
    got = mf.loglik_bwd_cuda(*planes, *pix, g)
    again = mf.loglik_bwd_cuda(*planes, *pix, g)
    want = mf._loglik_bwd_torch(*planes, *pix, g)
    for name, a, a2, w in zip("amp mx my pa pb pc".split(), got, again, want):
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a, w, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
@pytest.mark.parametrize("b", [1, 9, 32, 64, 1000, 4096])
def test_k1_any_batch_matches_plain_and_repeats(cuda, kind, b):
    """Every geometry k1_geometry picks on a 25x25 stamp: one chain per
    block in clusters of up to 8 (B <= 64), 4 chains per block (B=1000), 8
    (B=4096)."""
    planes, pd, _, _ = _planes(kind, b, cuda, seed=b)
    _check_k1(planes, pd, kind)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
@pytest.mark.parametrize("side", [96, 128])
def test_k1_large_stamps_have_no_pixel_cap(cuda, kind, side):
    """96x96 and 128x128 stamps (9216 and 16384 pixels, more than a block's
    shared memory holds): the forward at every B, the backward at B <= 64."""
    for b in (1, 9, 32, 64, 1000, 4096):
        planes, pd, _, _ = _planes(kind, b, cuda, seed=b, shape=(side, side))
        _check_k1(planes, pd, kind, bwd=b <= 64)


def test_k1_geometry_as_launched(cuda):
    """One launch per call, at the geometry the chooser gives."""
    planes, pd, _, _ = _planes("galaxy", 32, cuda)
    assert mf.k1_geometry(32, pd[0].shape[1]) == (1, 8)
    before = mf.launch_counts()
    mf.loglik_fwd_cuda(*planes, *pd)
    mf.loglik_bwd_cuda(*planes, *pd, torch.ones(32, device=cuda))
    after = mf.launch_counts()
    assert after["mog_field_loglik_fwd"] == before["mog_field_loglik_fwd"] + 1
    assert after["mog_field_loglik_bwd"] == before["mog_field_loglik_bwd"] + 1


# ---------------------------------------------------------------------------
# the tiled field kernels K2, K3, K4 (config 5)
# ---------------------------------------------------------------------------

TILED_TOL = dict(rtol=2e-6, atol=1.0)
TILED_GRAD_TOL = dict(rtol=5e-4, atol=0.1)
LAM_TOL = dict(rtol=1e-5, atol=1e-3)
RENDER_BWD_RANDOM_TOL = dict(rtol=2e-4, atol=5e-3)


@pytest.fixture(scope="module")
def config5(cuda):
    from celeste_tpu_torch.bench.config5 import build_config5

    logd, logd_dense, vec, info = build_config5(device=cuda)
    return logd, logd_dense, vec, info


def _c5_planes(config5, n, seed=0):
    _, _, vec, info = config5
    rng = np.random.default_rng(seed)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(n, vec.shape[0])),
                                       dtype=torch.float32, device=vec.device)
    return [p.contiguous() for p in tf.scene_planes_blocked(info["scene"], vecs, info["stamp"], 0)]


def _autograd_plain(planes, tile_src, pixels, g, chunk=128):
    """Torch autograd through the plain forward, a chain chunk at a time."""
    out = []
    for c0 in range(0, planes[0].shape[0], chunk):
        leaves = [p[c0:c0 + chunk].clone().requires_grad_(True) for p in planes]
        ll = tf._tiled_torch(leaves, tile_src, pixels, 3)
        out.append(torch.autograd.grad(ll, leaves, g[c0:c0 + chunk]))
    return [torch.cat(d) for d in zip(*out)]


@pytest.mark.parametrize("centered", [False, True])
def test_tiled_forward_kernels_match_plain(cuda, config5, centered):
    planes = _c5_planes(config5, 1000)
    for bk in config5[3]["tiled_data"].bucket_tables:
        want, want_lam = tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, 3, centered)
        got = tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3, centered=centered)
        ll, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3,
                                        centered=centered)
        torch.testing.assert_close(got, want, **TILED_TOL)
        torch.testing.assert_close(ll, want, **TILED_TOL)
        torch.testing.assert_close(lam, want_lam, **LAM_TOL)
        holed = bk.pixels[4].clone()
        holed[:, ::7] = 0.0
        pix = (*bk.pixels[:4], holed)
        torch.testing.assert_close(tf.tiled_fwd_cuda(*planes, bk.tile_src, *pix, n_comp=3,
                                                     centered=centered),
                                   tf._tiled_torch(planes, bk.tile_src, pix, 3, centered),
                                   **TILED_TOL)


def test_tiled_backward_kernel_matches_autograd(cuda, config5):
    planes = _c5_planes(config5, 333, seed=1)
    g = torch.as_tensor(np.random.default_rng(2).normal(size=333).astype(np.float32), device=cuda)
    for bk in config5[3]["tiled_data"].bucket_tables:
        _, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
        cols = bk.columns(3, planes[0].shape[1])
        got = tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols, n_comp=3)
        want = _autograd_plain(planes, bk.tile_src, bk.pixels, g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TILED_GRAD_TOL)


def test_tiled_backward_random_planes_and_determinism(cuda):
    planes, tile_src, pixels, g = random_tile_problem(seed=5, b=37, s=4, t=3)
    planes = [torch.as_tensor(p, device=cuda) for p in planes]
    ts = torch.as_tensor(tile_src, device=cuda)
    pixels = [torch.as_tensor(p, device=cuda) for p in pixels]
    g = torch.as_tensor(g, device=cuda)
    ll, lam = tf.tiled_fwd_lam_cuda(*planes, ts, *pixels, n_comp=3)
    cols = [torch.as_tensor(c, device=cuda) for c in tf.tile_columns(tile_src, 3, 15)]
    got = tf.tiled_bwd_cuda(*planes, ts, *pixels, lam, g, *cols, n_comp=3)
    want_ll, want_lam = tf._tiled_lam_torch(planes, ts, pixels, 3)
    torch.testing.assert_close(ll, want_ll, rtol=2e-5, atol=2e-2)
    for a, w in zip(got, tf._tiled_bwd_torch(planes, ts, pixels, want_lam, g, 3)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=5e-3)
    for a, w in zip(got, _autograd_plain(planes, ts, pixels, g)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=5e-3)
    again = tf.tiled_bwd_cuda(*planes, ts, *pixels, lam, g, *cols, n_comp=3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tiled_sentinel_adds_nothing_and_has_finite_gradients(cuda):
    planes, _, pixels, g = random_tile_problem(seed=11, b=9)
    planes = [torch.as_tensor(p, device=cuda) for p in planes]
    pixels = [torch.as_tensor(p, device=cuda) for p in pixels]
    only_sentinel = torch.full((3, 4), 4, dtype=torch.int32, device=cuda)
    _, lam = tf.tiled_fwd_lam_cuda(*planes, only_sentinel, *pixels, n_comp=3)
    assert torch.equal(lam, pixels[3][:, None, :].expand_as(lam))
    cols = [torch.as_tensor(c, device=cuda)
            for c in tf.tile_columns(only_sentinel.cpu().numpy(), 3, 15)]
    grads = tf.tiled_bwd_cuda(*planes, only_sentinel, *pixels, lam,
                              torch.as_tensor(g, device=cuda), *cols, n_comp=3)
    assert all(bool(torch.isfinite(d).all()) for d in grads)
    assert all(bool((d[:, :12] == 0).all()) for d in grads)


def _on(device, arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("b", [1, 9, 1000])
@pytest.mark.parametrize("s_cap,c", [(1, 1), (1, 3), (5, 1), (5, 3)])
def test_tiled_kernels_any_entry_count_and_batch(cuda, b, s_cap, c):
    """Entry counts (1, 3, 5, 15) that fill no whole pass of the backward's
    entries, and batches that fill no whole block of 8 chains: K3, K4, K5
    and K6 against their plain versions, and K3's lambda and K4's and K6's
    cotangents twice, bitwise equal."""
    planes, tile_src, pixels, g = random_tile_problem(seed=b + 10 * s_cap + c, b=b, s=s_cap,
                                                      c=c, t=3)
    planes, pixels = _on(cuda, planes), _on(cuda, pixels)
    ts, g = torch.as_tensor(tile_src, device=cuda), torch.as_tensor(g, device=cuda)
    cols = _on(cuda, tf.tile_columns(tile_src, c, (s_cap + 1) * c))
    want_ll, want_lam = tf._tiled_lam_torch(planes, ts, pixels, c)
    ll, lam = tf.tiled_fwd_lam_cuda(*planes, ts, *pixels, n_comp=c)
    torch.testing.assert_close(ll, want_ll, rtol=2e-5, atol=2e-2)
    torch.testing.assert_close(lam, want_lam, **LAM_TOL)
    assert torch.equal(lam, tf.tiled_fwd_lam_cuda(*planes, ts, *pixels, n_comp=c)[1])
    got = tf.tiled_bwd_cuda(*planes, ts, *pixels, lam, g, *cols, n_comp=c)
    again = tf.tiled_bwd_cuda(*planes, ts, *pixels, lam, g, *cols, n_comp=c)
    for a, w, a2 in zip(got, tf._tiled_bwd_torch(planes, ts, pixels, lam, g, c), again):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=5e-3)
        assert torch.equal(a, a2)
    px, py = pixels[:2]
    torch.testing.assert_close(tf.tiled_render_cuda(*planes, ts, px, py, n_comp=c),
                               tf._tiled_render_torch(planes, ts, px, py, c), **LAM_TOL)
    gr = torch.as_tensor(np.random.default_rng(b).normal(size=(3, b, 1024)).astype(np.float32),
                         device=cuda)
    got = tf.tiled_render_bwd_cuda(*planes, ts, px, py, gr, *cols, n_comp=c)
    again = tf.tiled_render_bwd_cuda(*planes, ts, px, py, gr, *cols, n_comp=c)
    for a, w, a2 in zip(got, tf._tiled_render_bwd_torch(planes, ts, px, py, gr, c), again):
        torch.testing.assert_close(a, w, **RENDER_BWD_RANDOM_TOL)
        assert torch.equal(a, a2)


def _padded_field(device, b, seed=41):
    """Six stars of three components each on a 41x41 field, cut into six
    8x128 tiles whose pad (x >= 41 or y >= 41) has mask 0 and sky 1, in two
    occupancy buckets; ``b`` chains of planes scattered around the stars."""
    from types import SimpleNamespace

    from celeste_tpu_torch.parallel import tiles

    rng = np.random.default_rng(seed)
    n_src, c = 6, 3
    pos = rng.uniform(3.0, 38.0, (n_src, 2))
    tm = tiles.build_tile_map(pos, 8.0, (41, 41))
    field = SimpleNamespace(
        counts=torch.as_tensor(rng.poisson(20.0, (41, 41)).astype(np.float32), device=device),
        sky=torch.full((41, 41), 15.0, device=device), mask=torch.ones(41, 41, device=device))
    data = tf.TiledStampData(tm, field, n_buckets=2)
    w = (n_src + 1) * c
    centre = np.repeat(pos, c, axis=0)                                    # [S*C, 2]
    mx = centre[None, :, 0] + 0.3 * rng.normal(size=(b, n_src * c))
    my = centre[None, :, 1] + 0.3 * rng.normal(size=(b, n_src * c))
    planes = [np.abs(rng.normal(5.0, 1.0, (b, n_src * c))), mx, my,
              np.abs(rng.normal(0.5, 0.1, (b, n_src * c))), 0.05 * rng.normal(size=(b, n_src * c)),
              np.abs(rng.normal(0.5, 0.1, (b, n_src * c)))]
    planes = [torch.as_tensor(np.concatenate([p, np.zeros((b, c))], 1).astype(np.float32),
                              device=device) for p in planes]
    assert planes[0].shape == (b, w)
    return planes, data


@pytest.mark.parametrize("b", [1, 9, 1000])
def test_tiled_kernels_on_a_padded_field(cuda, b):
    """A 41x41 field: K2, K3 and K4 against their plain versions per
    bucket, the pad's pixels (mask 0, sky 1) adding nothing to the
    log-likelihood, and K4 twice, bitwise equal."""
    planes, data = _padded_field(cuda, b)
    g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32), device=cuda)
    assert len(data.bucket_tables) == 2
    for bk in data.bucket_tables:
        assert bool((bk.pixels[4][bk.pixels[0] >= 41] == 0).all())
        assert bool((bk.pixels[3][bk.pixels[1] >= 41] == 1).all())
        want_ll, want_lam = tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, 3, True)
        ll, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3,
                                        centered=True)
        torch.testing.assert_close(ll, want_ll, **TILED_TOL)
        torch.testing.assert_close(lam, want_lam, **LAM_TOL)
        torch.testing.assert_close(tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3,
                                                     centered=True), want_ll, **TILED_TOL)
        cols = bk.columns(3, planes[0].shape[1])
        got = tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols, n_comp=3)
        again = tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols, n_comp=3)
        want = tf._tiled_bwd_torch(planes, bk.tile_src, bk.pixels, lam, g, 3)
        for a, w, a2 in zip(got, want, again):
            torch.testing.assert_close(a, w, **TILED_GRAD_TOL)
            assert torch.equal(a, a2)


def test_tiled_lambda_of_ex2_is_within_lam_tol_of_float64(cuda, config5):
    """K3's lambda, whose exponentials are ex2.approx, against the plain
    version in float32 and in float64 on config 5's buckets, at LAM_TOL."""
    planes = _c5_planes(config5, 1000, seed=4)
    for bk in config5[3]["tiled_data"].bucket_tables:
        _, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
        _, want = tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, 3)
        _, want64 = tf._tiled_lam_torch([p.double() for p in planes], bk.tile_src,
                                        [p.double() for p in bk.pixels], 3)
        torch.testing.assert_close(lam, want, **LAM_TOL)
        torch.testing.assert_close(lam.double(), want64, **LAM_TOL)


@pytest.mark.parametrize("b", [1, 9, 65536])
def test_tiled_forward_any_batch(cuda, config5, b):
    planes = _c5_planes(config5, b, seed=b)
    bk = config5[3]["tiled_data"].bucket_tables[1]
    got = tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
    rows = torch.cat([torch.arange(min(b, 64)), torch.arange(max(0, b - 64), b)]).to(cuda)
    want = tf._tiled_torch([p[rows] for p in planes], bk.tile_src, bk.pixels, 3)
    torch.testing.assert_close(got[rows], want, **TILED_TOL)


def test_tiled_entry_point_launches_k2_or_k3_k4(cuda, config5):
    logd, _, vec, info = config5
    n_buckets = len(info["tiled_data"].bucket_tables)
    vecs = vec[None] + 0.01 * torch.randn((64, vec.shape[0]), device=cuda,
                                          generator=torch.Generator(cuda).manual_seed(0))
    before = tf.launch_counts()
    with torch.no_grad():
        val = logd(vecs)
    mid = tf.launch_counts()
    assert mid["tiled_field_fwd"] == before["tiled_field_fwd"] + n_buckets
    x = vecs.clone().requires_grad_(True)
    out = logd(x)
    (gx,) = torch.autograd.grad(out.sum(), x)
    after = tf.launch_counts()
    assert after["tiled_field_fwd_lam"] == mid["tiled_field_fwd_lam"] + n_buckets
    assert after["tiled_field_bwd"] == mid["tiled_field_bwd"] + n_buckets
    torch.testing.assert_close(out.detach(), val, rtol=1e-6, atol=1e-3)
    from celeste_tpu_torch.bench.config5 import build_config5

    logd_cpu, _, _, _ = build_config5(device="cpu")
    xc = vecs.cpu().requires_grad_(True)
    want = logd_cpu(xc)
    (gw,) = torch.autograd.grad(want.sum(), xc)
    torch.testing.assert_close(out.detach().cpu(), want.detach(), **TILED_TOL)
    torch.testing.assert_close(gx.cpu(), gw, **TILED_GRAD_TOL)


def test_tiled_wrappers_reject_bad_inputs(cuda, config5):
    planes = _c5_planes(config5, 8)
    bk = config5[3]["tiled_data"].bucket_tables[0]
    pix = bk.pixels
    with pytest.raises(ValueError, match="dtype"):
        tf.tiled_fwd_cuda(planes[0].double(), *planes[1:], bk.tile_src, *pix, n_comp=3)
    with pytest.raises(ValueError, match="dtype"):
        tf.tiled_fwd_cuda(*planes, bk.tile_src.long(), *pix, n_comp=3)
    with pytest.raises(ValueError, match="contiguous"):
        tf.tiled_fwd_cuda(planes[0].t().contiguous().t(), *planes[1:], bk.tile_src, *pix,
                          n_comp=3)
    with pytest.raises(ValueError, match="shape"):
        tf.tiled_fwd_cuda(*planes, bk.tile_src, pix[0][:, :-1], *pix[1:], n_comp=3)
    with pytest.raises(ValueError):
        tf.tiled_fwd_cuda(*planes, bk.tile_src.cpu(), *pix, n_comp=3)
    with pytest.raises(ValueError, match="planes must be"):
        tf.tiled_fwd_cuda(*[p[:, :-1].contiguous() for p in planes], bk.tile_src, *pix,
                          n_comp=3)
    _, lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *pix, n_comp=3)
    col_ptr, col_ent = bk.columns(3, planes[0].shape[1])
    g = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="col_ent"):
        tf.tiled_bwd_cuda(*planes, bk.tile_src, *pix, lam, g, col_ptr, col_ent[:-1], n_comp=3)
    with pytest.raises(ValueError, match="lam"):
        tf.tiled_bwd_cuda(*planes, bk.tile_src, *pix, lam[:, :4], g, col_ptr, col_ent, n_comp=3)


# ---------------------------------------------------------------------------
# the render kernels K5, K6 (the source-sharded field)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# K2-K6 past the whole-tile staging: the staged path (no component cap)
# ---------------------------------------------------------------------------

# components a tile: 780 (260 random slots of 3: K2, K3 and K5 whole, K4
# and K6 staged), the densest buckets of the tiled crowded_field of 32
# sources (24 galaxies) and of 48 (32) on 64x64 (891, 1218), and 50 random
# slots of 48 (2400); at 203 chains, whose last block of 8 is not whole
LARGE_TILES = ("random 780", "crowded 891", "crowded 1218", "random 2400")
LARGE_TILE_CHAINS = 203
TILED_COUNTERS = {"K2": "tiled_field_fwd", "K3": "tiled_field_fwd_lam", "K4": "tiled_field_bwd",
                  "K5": "tiled_field_render", "K6": "tiled_field_render_bwd"}
TILED_KINDS = {"K2": "fwd", "K3": "fwd", "K4": "bwd", "K5": "render", "K6": "bwd"}


def _large_tile_problem(cuda, name, b):
    """(buckets, planes, sentinel, components a slot, K4's and K6's
    tolerance) of one of LARGE_TILES."""
    from celeste_tpu_torch.bench.tiled_turns import crowded_tiles, random_tiles

    if name.startswith("random"):
        s, c = {"random 780": (260, 3), "random 2400": (50, 48)}[name]
        return (*random_tiles(s, c, b, cuda, seed=s), RENDER_BWD_RANDOM_TOL)
    n, ng = {"crowded 891": (32, 24), "crowded 1218": (48, 32)}[name]
    return (*crowded_tiles(n, ng, (64, 64), b, cuda), TILED_GRAD_TOL)


def _tiled_calls(planes, bk, c, lam, g, g_r):
    """{kernel: a wrapper call returning its outputs as a tuple} of one
    bucket; K4 reads ``lam``, K6 the cotangent ``g_r``."""
    px, py = bk.pixels[:2]
    cols = bk.columns(c, planes[0].shape[1])
    return {
        "K2": lambda: (tf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c),),
        "K3": lambda: tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c),
        "K4": lambda: tf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, g, *cols,
                                        n_comp=c),
        "K5": lambda: (tf.tiled_render_cuda(*planes, bk.tile_src, px, py, n_comp=c),),
        "K6": lambda: tf.tiled_render_bwd_cuda(*planes, bk.tile_src, px, py, g_r, *cols,
                                               n_comp=c)}


def _force_tile_path(monkeypatch, staged: bool):
    """Make the tiled wrappers take the staged (or the whole-tile) path."""
    monkeypatch.setattr(tf, "tile_staged", lambda kernel, n_k: staged)


def _bucket_inputs(cuda, planes, bk, c, seed):
    """K3's lambda for K4, the output cotangent g [B] and K6's [T, B, PIX]."""
    b = planes[0].shape[0]
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.normal(size=b).astype(np.float32), device=cuda)
    g_r = torch.as_tensor(rng.normal(size=(bk.tile_src.shape[0], b, 1024)).astype(np.float32),
                          device=cuda)
    lam = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=c)[1]
    return lam, g, g_r


@pytest.mark.parametrize("name", LARGE_TILES)
def test_large_tiles_match_plain(cuda, monkeypatch, name):
    """K2-K6 on every bucket of a table past the whole-tile staging against
    their plain versions: K2 and K3's log-likelihood rtol 2e-6 + atol 1.0,
    K3's and K5's lambda rtol 1e-5 + atol 1e-3, K4 and K6 on the kernels'
    own lambda (crowded fields rtol 5e-4 + atol 0.1, random problems rtol
    2e-4 + atol 5e-3); one launch a call; two calls bitwise equal; where the
    other path also fits, it gives the same bits."""
    buckets, planes, _, c, bwd_tol = _large_tile_problem(cuda, name, LARGE_TILE_CHAINS)
    assert any(tf.tile_staged("bwd", bk.s_cap * c) for bk in buckets)
    for i, bk in enumerate(buckets):
        n_k = bk.s_cap * c
        lam, g, g_r = _bucket_inputs(cuda, planes, bk, c, seed=i)
        px, py = bk.pixels[:2]
        want_ll, want_lam = tf._tiled_lam_torch(planes, bk.tile_src, bk.pixels, c)
        want = {"K2": (want_ll,), "K3": (want_ll, want_lam),
                "K4": tf._tiled_bwd_torch(planes, bk.tile_src, bk.pixels, lam, g, c),
                "K5": (tf._tiled_render_torch(planes, bk.tile_src, px, py, c),),
                "K6": tf._tiled_render_bwd_torch(planes, bk.tile_src, px, py, g_r, c)}
        tols = {"K2": [TILED_TOL], "K3": [TILED_TOL, LAM_TOL], "K4": [bwd_tol] * 6,
                "K5": [LAM_TOL], "K6": [bwd_tol] * 6}
        for kernel, fn in _tiled_calls(planes, bk, c, lam, g, g_r).items():
            before = tf.launch_counts()[TILED_COUNTERS[kernel]]
            got = [t.clone() for t in fn()]
            assert tf.launch_counts()[TILED_COUNTERS[kernel]] == before + 1, kernel
            assert all(torch.equal(a, a2) for a, a2 in zip(got, fn())), kernel
            for a, w, tol in zip(got, want[kernel], tols[kernel]):
                torch.testing.assert_close(a, w, **tol, msg=f"{name} bucket {i} {kernel}")
            if tf.tile_smem_bytes(TILED_KINDS[kernel], n_k) <= tf.SMEM_OPTIN:
                with monkeypatch.context() as m:
                    _force_tile_path(m, not tf.tile_staged(TILED_KINDS[kernel], n_k))
                    other = fn()
                assert all(torch.equal(a, o) for a, o in zip(got, other)), kernel


@pytest.mark.parametrize("n_k", [114, 600])
def test_staged_tile_path_gives_the_whole_tile_bits(cuda, config5, monkeypatch, n_k):
    """Tiles that fit the whole-tile staging, config 5's two buckets (99 and
    114 components) at 1000 chains and 200 random slots of 3 (600) at 203:
    the staged path asked for gives K2-K6's bits."""
    if n_k == 114:
        buckets, planes, c = config5[3]["tiled_data"].bucket_tables, _c5_planes(config5, 1000), 3
    else:
        from celeste_tpu_torch.bench.tiled_turns import random_tiles

        buckets, planes, _, c = random_tiles(200, 3, LARGE_TILE_CHAINS, cuda, seed=6)
    assert max(bk.s_cap for bk in buckets) * c == n_k
    for i, bk in enumerate(buckets):
        assert not any(tf.tile_staged(k, bk.s_cap * c) for k in ("fwd", "render", "bwd"))
        lam, g, g_r = _bucket_inputs(cuda, planes, bk, c, seed=i)
        for kernel, fn in _tiled_calls(planes, bk, c, lam, g, g_r).items():
            whole = [t.clone() for t in fn()]
            with monkeypatch.context() as m:
                _force_tile_path(m, True)
                staged = fn()
            assert all(torch.equal(a, s_) for a, s_ in zip(whole, staged)), (kernel, i)


def test_whole_tile_past_the_staging_fails_loudly(cuda, monkeypatch):
    """At 891 components a tile (297 random slots of 3) every kernel takes
    the staged path; the whole-tile path asked for there is refused by the
    launch: each wrapper raises, counting nothing."""
    from celeste_tpu_torch.bench.tiled_turns import random_tiles

    (bk,), planes, _, c = random_tiles(297, 3, 16, cuda, seed=9)
    assert all(tf.tile_staged(k, 891) for k in ("fwd", "render", "bwd"))
    lam, g, g_r = _bucket_inputs(cuda, planes, bk, c, seed=0)
    calls = _tiled_calls(planes, bk, c, lam, g, g_r)
    _force_tile_path(monkeypatch, False)
    for kernel, fn in calls.items():
        before = tf.launch_counts()
        with pytest.raises(RuntimeError, match="launch failed"):
            fn()
        assert tf.launch_counts() == before, kernel


def test_crowded_field_past_the_whole_tile_runs_on_the_card(cuda):
    """``crowded_field tiled=true`` with 32 sources (24 galaxies) on 64x64,
    through ``experiments._crowded_problem``: its log density and gradient
    at 8 chains through K3 and K4 (the densest bucket's 891 components a
    tile on the staged path), one launch of each per bucket, equal to the
    CPU's plain path at the tiled gates."""
    import copy

    from celeste_tpu_torch.experiments import CONFIGS, _crowded_problem

    out = {}
    for device in ("cpu", cuda):
        cfg = copy.deepcopy(CONFIGS["crowded_field"])
        cfg.tiled, cfg.n_sources, cfg.n_galaxies, cfg.shape = True, 32, 24, (64, 64)
        _, logd, x0 = _crowded_problem(cfg, torch.device(device))
        xs = (x0[None] + 0.01 * np.random.default_rng(8).normal(size=(8, x0.size)))
        xt = torch.tensor(xs.astype(np.float32), device=device, requires_grad=True)
        before = tf.launch_counts()
        val = logd(xt)
        (grad,) = torch.autograd.grad(val.sum(), xt)
        after = tf.launch_counts()
        out[str(device)] = (val.detach().cpu(), grad.cpu(),
                            {k: after[k] - before[k] for k in after})
    assert out["cuda:0"][2] == {"tiled_field_fwd": 0, "tiled_field_fwd_lam": 2,
                                "tiled_field_bwd": 2, "tiled_field_render": 0,
                                "tiled_field_render_bwd": 0}
    torch.testing.assert_close(out["cuda:0"][0], out["cpu"][0], **TILED_TOL)
    torch.testing.assert_close(out["cuda:0"][1], out["cpu"][1], **TILED_GRAD_TOL)


@pytest.fixture(scope="module")
def sharded5(config5):
    """Config 5 on one rank: the rectangular posterior's sharded pieces."""
    from celeste_tpu_torch.bench.config5 import build_config5_sharded

    return build_config5_sharded(config5[3], None)


def _rect_states(sharded5, n, seed=0):
    rect = sharded5["rect"]
    rng = np.random.default_rng(seed)
    return rect[None] + torch.as_tensor(0.01 * rng.normal(size=(n,) + tuple(rect.shape)),
                                        dtype=torch.float32, device=rect.device)


def test_render_kernel_matches_plain(cuda, sharded5):
    planes = [p.contiguous() for p in sharded5["loglik"].planes(_rect_states(sharded5, 1000))]
    for bk in sharded5["loglik"].buckets:
        got = tf.tiled_render_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
        want = tf._tiled_render_torch(planes, bk.tile_src, *bk.pixels, 3)
        torch.testing.assert_close(got, want, **LAM_TOL)


def test_render_backward_kernel_matches_plain_and_autograd(cuda, sharded5):
    planes = [p.contiguous() for p in sharded5["loglik"].planes(_rect_states(sharded5, 257, 1))]
    for bk in sharded5["loglik"].buckets:
        g = torch.as_tensor(np.random.default_rng(2).normal(
            size=(bk.tile_src.shape[0], 257, 1024)).astype(np.float32), device=cuda)
        got = tf.tiled_render_bwd_cuda(*planes, bk.tile_src, *bk.pixels, g,
                                       *bk.columns(3, planes[0].shape[1]), n_comp=3)
        hand = tf._tiled_render_bwd_torch(planes, bk.tile_src, *bk.pixels, g, 3)
        leaves = [p.clone().requires_grad_(True) for p in planes]
        auto = torch.autograd.grad(tf._tiled_render_torch(leaves, bk.tile_src, *bk.pixels, 3),
                                   leaves, g)
        for a, h, w in zip(got, hand, auto):
            torch.testing.assert_close(a, h, **TILED_GRAD_TOL)
            torch.testing.assert_close(a, w, **TILED_GRAD_TOL)


def test_render_backward_random_planes_and_determinism(cuda):
    planes, tile_src, pixels, _ = random_tile_problem(seed=5, b=37, s=4, t=3)
    planes = [torch.as_tensor(p, device=cuda) for p in planes]
    ts = torch.as_tensor(tile_src, device=cuda)
    px, py = (torch.as_tensor(p, device=cuda) for p in pixels[:2])
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 37, 1024)).astype(np.float32),
                        device=cuda)
    cols = [torch.as_tensor(c, device=cuda) for c in tf.tile_columns(tile_src, 3, 15)]
    lam = tf.tiled_render_cuda(*planes, ts, px, py, n_comp=3)
    torch.testing.assert_close(lam, tf._tiled_render_torch(planes, ts, px, py, 3), **LAM_TOL)
    got = tf.tiled_render_bwd_cuda(*planes, ts, px, py, g, *cols, n_comp=3)
    for a, w in zip(got, tf._tiled_render_bwd_torch(planes, ts, px, py, g, 3)):
        torch.testing.assert_close(a, w, **RENDER_BWD_RANDOM_TOL)
    again = tf.tiled_render_bwd_cuda(*planes, ts, px, py, g, *cols, n_comp=3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_render_sentinel_is_exactly_zero(cuda):
    planes, _, pixels, _ = random_tile_problem(seed=11, b=9)
    planes = [torch.as_tensor(p, device=cuda) for p in planes]
    px, py = (torch.as_tensor(p, device=cuda) for p in pixels[:2])
    only_sentinel = torch.full((3, 4), 4, dtype=torch.int32, device=cuda)
    lam = tf.tiled_render_cuda(*planes, only_sentinel, px, py, n_comp=3)
    assert bool((lam == 0).all())
    cols = [torch.as_tensor(c, device=cuda)
            for c in tf.tile_columns(only_sentinel.cpu().numpy(), 3, 15)]
    grads = tf.tiled_render_bwd_cuda(*planes, only_sentinel, px, py, torch.ones_like(lam), *cols,
                                     n_comp=3)
    assert all(bool(torch.isfinite(d).all()) and bool((d[:, :12] == 0).all()) for d in grads)


def test_render_wrappers_reject_bad_inputs(cuda, sharded5):
    planes = [p.contiguous() for p in sharded5["loglik"].planes(_rect_states(sharded5, 8))]
    bk = sharded5["loglik"].buckets[0]
    px, py = bk.pixels
    with pytest.raises(ValueError, match="dtype"):
        tf.tiled_render_cuda(planes[0].double(), *planes[1:], bk.tile_src, px, py, n_comp=3)
    with pytest.raises(ValueError, match="contiguous"):
        tf.tiled_render_cuda(planes[0].t().contiguous().t(), *planes[1:], bk.tile_src, px, py,
                             n_comp=3)
    with pytest.raises(ValueError, match="shape"):
        tf.tiled_render_cuda(*planes, bk.tile_src, px[:, :-1], py, n_comp=3)
    with pytest.raises(ValueError):
        tf.tiled_render_cuda(*planes, bk.tile_src.cpu(), px, py, n_comp=3)
    lam = tf.tiled_render_cuda(*planes, bk.tile_src, px, py, n_comp=3)
    col_ptr, col_ent = bk.columns(3, planes[0].shape[1])
    with pytest.raises(ValueError, match="g has shape"):
        tf.tiled_render_bwd_cuda(*planes, bk.tile_src, px, py, lam[:, :4], col_ptr, col_ent,
                                 n_comp=3)
    with pytest.raises(ValueError, match="col_ent"):
        tf.tiled_render_bwd_cuda(*planes, bk.tile_src, px, py, lam, col_ptr, col_ent[:-1],
                                 n_comp=3)


def test_sharded_world1_matches_single_device_tiled(cuda, config5):
    """The sharded posterior on a one-rank NCCL mesh, through K5 and K6,
    against the single-device tiled posterior (K3 and K4) with the same
    radii: values and gradients at the card's gates, the star padding's
    likelihood gradient exactly 0."""
    from celeste_tpu_torch.bench.config5 import build_config5_sharded
    from celeste_tpu_torch.parallel import make_mesh, process_group

    info = config5[3]
    with process_group("nccl"):
        s5 = build_config5_sharded(info, make_mesh({"chains": 1, "sources": 1}, "cuda"))
        rect = _rect_states(s5, 64, seed=3)
        before = tf.launch_counts()
        x = rect.clone().requires_grad_(True)
        val = s5["logpost"](x)
        (g,) = torch.autograd.grad(val.sum(), x)
        x2 = rect.clone().requires_grad_(True)
        (g_ll,) = torch.autograd.grad(s5["loglik"](x2).sum(), x2)
        after = tf.launch_counts()
    n_buckets = len(s5["loglik"].buckets)
    assert after["tiled_field_render"] >= before["tiled_field_render"] + 2 * n_buckets
    assert after["tiled_field_render_bwd"] >= before["tiled_field_render_bwd"] + 2 * n_buckets
    cs = info["scene"]
    xp = cs.from_rect(rect).requires_grad_(True)
    want = s5["logd_ref"](xp)
    (gw,) = torch.autograd.grad(want.sum(), xp)
    torch.testing.assert_close(val.detach(), want.detach(), **TILED_TOL)
    torch.testing.assert_close(cs.from_rect(g), gw, **TILED_GRAD_TOL)
    for i, kind in enumerate(cs.kinds):
        if kind == "star":
            assert bool((g_ll[:, i, 3:] == 0).all())


def _nccl_rank(mesh_shape, n_chains):
    """One NCCL rank on its own card: the sharded config-5 posterior's value
    and gradient at ``n_chains`` states, on this rank's chains."""
    from celeste_tpu_torch.bench.config5 import build_config5, build_config5_sharded
    from celeste_tpu_torch.parallel import chain_sharding, make_mesh

    info = build_config5(device=torch.device("cuda", torch.cuda.current_device()))[3]
    mesh = make_mesh(mesh_shape, "cuda")
    s5 = build_config5_sharded(info, mesh)
    x = _rect_states(s5, n_chains, seed=5)[chain_sharding(mesh, n_chains)].requires_grad_(True)
    val = s5["logpost"](x)
    (g,) = torch.autograd.grad(val.sum(), x)
    return val.detach().cpu(), g.cpu()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_nccl_across_four_cards(cuda, sharded5, shape):
    """Four NCCL ranks, a card each, against one rank: the same value and
    gradient of the sharded config-5 posterior, chain block by chain
    block."""
    from celeste_tpu_torch.parallel import launch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 GPUs, this host has {torch.cuda.device_count()}")
    ranks = launch(_nccl_rank, 4, {"chains": shape[0], "sources": shape[1]}, 64,
                   backend="nccl")
    x = _rect_states(sharded5, 64, seed=5).requires_grad_(True)
    want = sharded5["logpost"](x)
    (want_g,) = torch.autograd.grad(want.sum(), x)
    per = 64 // shape[0]
    for rank, (val, g) in enumerate(ranks):
        rows = slice((rank // shape[1]) * per, (rank // shape[1] + 1) * per)
        torch.testing.assert_close(val, want.detach()[rows].cpu(), **TILED_TOL)
        torch.testing.assert_close(g, want_g[rows].cpu(), **TILED_GRAD_TOL)


# ---------------------------------------------------------------------------
# the stamp render kernel K7 and the separable kernels K8 (configs 2 and 3)
# ---------------------------------------------------------------------------

SEP_TOL = dict(rtol=2e-6, atol=0.5)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_render_stamp_kernel_matches_plain(cuda, kind):
    planes, pd, _, _ = _planes(kind, 1000, cuda)
    planes[0][::9] = 0.0                    # zero-amplitude rows render exactly the sky
    got = mf.render_cuda(*planes, pd[0], pd[1], pd[3])
    want = mf._render_torch(*planes, pd[0], pd[1], pd[3])
    assert tuple(got.shape) == (1000, 640)
    torch.testing.assert_close(got, want, **LAM_TOL)
    assert torch.equal(got[::9], pd[3].expand(got[::9].shape[0], -1))


def test_render_stamp_kernel_on_the_config5_field(cuda, config5):
    """K7 tiles the pixels: the 48x128 field (6144 pixels) renders with no cap."""
    _, _, vec, info = config5
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    vecs = vec[None] + 0.01 * torch.randn((64, vec.shape[0]), device=cuda,
                                          generator=torch.Generator(cuda).manual_seed(1))
    planes = [p.contiguous() for p in scene_field_planes(info["scene"], vecs, info["stamp"], 0)]
    pd = mf.stamp_pixel_data(info["stamp"])
    before = mf.launch_counts()["mog_field_render"]
    got = mf.mog_field_render(*planes, pd)
    assert mf.launch_counts()["mog_field_render"] == before + 1
    torch.testing.assert_close(got, mf._render_torch(*planes, pd[0], pd[1], pd[3]), **LAM_TOL)


# K7 at every geometry k7_geometry picks (B 1, 9, 32, 64, 1000, 4096), for a
# star's, a galaxy's and config 5's component counts, on 25x25, 31x31,
# 48x128 and 128x128 pixel sets (640, 1024, 6144, 16384 lanes)
K7_CHAINS = (1, 9, 32, 64, 1000, 4096)
K7_COMPONENTS = (3, 48, 126)
K7_SHAPES = ((25, 25), (31, 31), (48, 128), (128, 128))


def _render_problem(b, c, h, w, device, seed=0):
    planes, pix = mf.random_render_problem(b, c, h, w, seed=seed)
    return [torch.as_tensor(a, device=device) for a in planes], [
        torch.as_tensor(a, device=device) for a in pix]


@pytest.mark.parametrize("h,w", K7_SHAPES)
@pytest.mark.parametrize("c", K7_COMPONENTS)
@pytest.mark.parametrize("b", K7_CHAINS)
def test_render_kernel_at_every_geometry(cuda, b, c, h, w):
    """K7 against its plain version at LAM_TOL, padded lanes included; the
    zero-amplitude rows (every 9th chain) exactly the sky; one launch per
    call; two calls bitwise equal."""
    planes, (px, py, sky) = _render_problem(b, c, h, w, cuda, seed=b + c + w)
    before = mf.launch_counts()["mog_field_render"]
    got = mf.render_cuda(*planes, px, py, sky)
    again = mf.render_cuda(*planes, px, py, sky)
    assert mf.launch_counts()["mog_field_render"] == before + 2
    assert tuple(got.shape) == (b, px.shape[1])
    assert torch.equal(got, again)
    torch.testing.assert_close(got, mf._render_torch(*planes, px, py, sky), **LAM_TOL)
    assert torch.equal(got[::9], sky.expand(got[::9].shape[0], -1))


def test_render_kernel_component_cap_fails_loudly(cuda, monkeypatch):
    """At 8 chains per block (B=4096) K7 stages up to ~800 components of a
    row whole; past that it takes the staged path, which matches the plain
    version, and the whole-row path asked for there is refused by the
    launch: the wrapper raises, counting nothing."""
    assert mf.k7_geometry(4096, 640)[0] == 8
    assert not mf.components_staged("render", 8, 800) and mf.components_staged("render", 8, 900)
    planes, (px, py, sky) = _render_problem(4096, 800, 25, 25, cuda)
    torch.testing.assert_close(mf.render_cuda(*planes, px, py, sky),
                               mf._render_torch(*planes, px, py, sky), **LAM_TOL)
    planes, _ = _render_problem(4096, 900, 25, 25, cuda)
    torch.testing.assert_close(mf.render_cuda(*planes, px, py, sky),
                               mf._render_torch(*planes, px, py, sky), **LAM_TOL)
    before = mf.launch_counts()
    _force_path(monkeypatch, False)
    with pytest.raises(RuntimeError, match="launch failed at B=4096, C=900"):
        mf.render_cuda(*planes, px, py, sky)
    assert mf.launch_counts() == before


def test_render_wrapper_rejects_bad_inputs(cuda):
    planes, (px, py, sky) = _render_problem(8, 3, 25, 25, cuda)
    with pytest.raises(ValueError, match="dtype"):
        mf.render_cuda(planes[0].double(), *planes[1:], px, py, sky)
    with pytest.raises(ValueError, match="shape"):
        mf.render_cuda(*planes, px[:, :-1], py, sky)
    with pytest.raises(ValueError, match="shape"):
        mf.render_cuda(planes[0][:4], *planes[1:], px, py, sky)
    with pytest.raises(ValueError):
        mf.render_cuda(*planes, px.cpu(), py, sky)
    with pytest.raises(ValueError, match="CUDA"):
        mf.render_cuda(*(p.cpu() for p in planes), px.cpu(), py.cpu(), sky.cpu())


def _sep_planes(n, device, seed=0):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    _, _, vecs, stamp = _planes("star", n, device, seed=seed)
    planes = [t.contiguous() for t in ms.star_planes_isotropic(vecs, stamp, 2, 5)]
    return planes, ms.stamp_pixel_data_2d(stamp), vecs, stamp


@pytest.mark.parametrize("centered", [False, True])
def test_sep_forward_kernel_matches_plain_and_k1(cuda, centered):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pd, vecs, stamp = _sep_planes(1000, cuda)
    holed = pd[4].clone()
    holed[:, ::7] = 0.0
    for mask in (pd[4], holed):
        pix = (*pd[:4], mask)
        got = ms.sep_fwd_cuda(*planes, *pix, centered=centered)
        torch.testing.assert_close(got, ms._sep_loglik_torch(*planes, *pix, centered=centered),
                                   **SEP_TOL)
    k1 = mf.batched_stamp_loglik(vecs, stamp, band=2, n_bands=5, centered=centered)
    torch.testing.assert_close(ms.sep_fwd_cuda(*planes, *pd, centered=centered), k1, **SEP_TOL)


def test_sep_backward_kernel_matches_plain_autograd_and_repeats(cuda):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pd, _, _ = _sep_planes(777, cuda, seed=1)
    pd = (*pd[:4], pd[4].clone())
    pd[4][:, ::7] = 0.0
    planes[0][::5, 0] = 0.0                 # zero-amplitude components: finite cotangents
    g = torch.as_tensor(np.random.default_rng(2).normal(size=777).astype(np.float32),
                        device=cuda)
    got = ms.sep_bwd_cuda(*planes, *pd, g)
    again = ms.sep_bwd_cuda(*planes, *pd, g)
    hand = ms._sep_loglik_bwd_torch(*planes, *pd, g)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    auto = torch.autograd.grad(ms._sep_loglik_torch(*leaves, *pd), leaves, g)
    for a, h, w, a2 in zip(got, hand, auto, again):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, h, **GRAD_TOL)
        torch.testing.assert_close(a, w, **GRAD_TOL)
        assert torch.equal(a, a2)


def test_sep_kernels_on_a_128x128_stamp(cuda):
    """K8 walks a stamp in bands of rows: a 128x128 stamp (16384 pixels,
    more than the backward's shared memory holds at once) against the plain
    versions, both ways centered, and two backward calls bitwise equal."""
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    _, _, vecs, stamp = _planes("star", 64, cuda, shape=(128, 128))
    planes = [t.contiguous() for t in ms.star_planes_isotropic(vecs, stamp, 2, 5)]
    pd = ms.stamp_pixel_data_2d(stamp)
    for centered in (False, True):
        torch.testing.assert_close(ms.sep_fwd_cuda(*planes, *pd, centered=centered),
                                   ms._sep_loglik_torch(*planes, *pd, centered=centered),
                                   **SEP_TOL)
    g = torch.as_tensor(np.random.default_rng(4).normal(size=64).astype(np.float32), device=cuda)
    got = ms.sep_bwd_cuda(*planes, *pd, g)
    again = ms.sep_bwd_cuda(*planes, *pd, g)
    for a, a2, w in zip(got, again, ms._sep_loglik_bwd_torch(*planes, *pd, g)):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, w, **GRAD_TOL)


SEP_SHAPES = [(c, h, w) for w, h in ((25, 21), (31, 26), (32, 27), (33, 40), (64, 57), (100, 90))
              for c in (1, 3, 4, 5)]


def _sep_problem(b, c, h, w, device, seed=0):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pix, g = ms.random_sep_problem(b, c, h, w, seed=seed)
    return ([torch.as_tensor(a, device=device) for a in planes],
            [torch.as_tensor(a, device=device) for a in pix], torch.as_tensor(g, device=device))


@pytest.mark.parametrize("c,h,w", SEP_SHAPES)
@pytest.mark.parametrize("b", [1, 7, 4096])
def test_sep_kernels_at_any_shape(cuda, b, c, h, w):
    """K8 at widths below, at and above a warp's 32 columns and over several
    column blocks, H != W, C on both sides of the C <= 4 template: K8-fwd
    against its plain version (centered both ways, full and holed masks)
    and against K1 on the same problem; K8-bwd against its plain version and
    torch autograd, finite at zero-amplitude components, two calls bitwise
    equal."""
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pix, g = _sep_problem(b, c, h, w, cuda, seed=b + c + w)
    full = (*pix[:4], torch.ones_like(pix[4]))
    for mask_name, px in (("holed", pix), ("full", full)):
        for centered in (False, True):
            got = ms.sep_fwd_cuda(*planes, *px, centered=centered)
            assert torch.equal(got, ms.sep_fwd_cuda(*planes, *px, centered=centered))
            torch.testing.assert_close(
                got, ms._sep_loglik_torch(*planes, *px, centered=centered), **SEP_TOL,
                msg=f"{mask_name} centered={centered}")
            k1_planes, k1_pix = ms.sep_as_k1(*planes, *px)
            torch.testing.assert_close(got, mf.loglik_fwd_cuda(*k1_planes, *k1_pix,
                                                               centered=centered), **SEP_TOL)
    got = ms.sep_bwd_cuda(*planes, *pix, g)
    again = ms.sep_bwd_cuda(*planes, *pix, g)
    hand = ms._sep_loglik_bwd_torch(*planes, *pix, g)
    leaves = [t.clone().requires_grad_(True) for t in planes]
    auto = torch.autograd.grad(ms._sep_loglik_torch(*leaves, *pix), leaves, g)
    for name, a, a2, hd, au in zip(("amp", "cx", "cy", "iv"), got, again, hand, auto):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a, hd, **GRAD_TOL, msg=name)
        torch.testing.assert_close(a, au, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("c,h,w", [(3, 25, 25), (1, 40, 33), (5, 40, 33)])
def test_sep_kernels_at_65536_chains(cuda, c, h, w):
    """K8 at the evals/s chain count, against the plain versions taken in
    chunks of chains, and K8-fwd against K1."""
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pix, g = _sep_problem(65536, c, h, w, cuda, seed=c)
    for centered in (False, True):
        got = ms.sep_fwd_cuda(*planes, *pix, centered=centered)
        want = torch.cat([ms._sep_loglik_torch(*(p[i:i + 4096] for p in planes), *pix,
                                               centered=centered)
                          for i in range(0, 65536, 4096)])
        torch.testing.assert_close(got, want, **SEP_TOL)
        k1_planes, k1_pix = ms.sep_as_k1(*planes, *pix)
        torch.testing.assert_close(got, mf.loglik_fwd_cuda(*k1_planes, *k1_pix,
                                                           centered=centered), **SEP_TOL)
    got = ms.sep_bwd_cuda(*planes, *pix, g)
    hand = [torch.cat(t) for t in zip(*(ms._sep_loglik_bwd_torch(
        *(p[i:i + 4096] for p in planes), *pix, g[i:i + 4096]) for i in range(0, 65536, 4096)))]
    for a, a2, hd in zip(got, ms.sep_bwd_cuda(*planes, *pix, g), hand):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, hd, **GRAD_TOL)


def test_sep_entry_point_launches_both_kernels(cuda):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    _, _, vecs, stamp = _sep_planes(96, cuda)
    before = ms.launch_counts()
    x = vecs.clone().requires_grad_(True)
    out = mf.batched_stamp_loglik(x, stamp, band=2, n_bands=5, impl="sep")
    (gx,) = torch.autograd.grad(out.sum(), x)
    after = ms.launch_counts()
    assert after["mog_field_sep_fwd"] == before["mog_field_sep_fwd"] + 1
    assert after["mog_field_sep_bwd"] == before["mog_field_sep_bwd"] + 1
    x_cpu = vecs.cpu().requires_grad_(True)
    want = mf.batched_stamp_loglik(x_cpu, stamp.to("cpu"), band=2, n_bands=5, impl="sep")
    (gw,) = torch.autograd.grad(want.sum(), x_cpu)
    torch.testing.assert_close(out.detach().cpu(), want.detach(), **SEP_TOL)
    torch.testing.assert_close(gx.cpu(), gw, **GRAD_TOL)


def test_sep_and_render_wrappers_reject_bad_inputs(cuda):
    from celeste_tpu_torch.kernels import mog_field_sep as ms

    planes, pd, _, _ = _sep_planes(8, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ms.sep_fwd_cuda(planes[0].double(), *planes[1:], *pd)
    with pytest.raises(ValueError, match="shape"):
        ms.sep_fwd_cuda(*planes, pd[0][:, :-1], *pd[1:])
    with pytest.raises(ValueError):
        ms.sep_fwd_cuda(*planes, pd[0].cpu(), *pd[1:])
    with pytest.raises(ValueError, match="g has"):
        ms.sep_bwd_cuda(*planes, *pd, torch.ones(7, device=cuda))
    # the stamp is staged in bands of whole rows, 16 bytes a pixel, so only a
    # row wider than shared memory holds (about 14000 pixels) fails
    big = [torch.ones(1, 16384, device=cuda), torch.ones(1, 2, device=cuda)] + [
        torch.ones(2, 16384, device=cuda) for _ in range(3)]
    before = ms.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        ms.sep_bwd_cuda(*planes, *big, torch.ones(8, device=cuda))
    assert ms.launch_counts() == before
    rplanes, rpd, _, _ = _planes("star", 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mf.render_cuda(rplanes[0].t().contiguous().t(), *rplanes[1:], rpd[0], rpd[1], rpd[3])


# ---------------------------------------------------------------------------
# checkpoint/resume and quasar photo-z on the card
# ---------------------------------------------------------------------------

def test_photo_z_projection_on_the_card_matches_the_cpu(cuda):
    """``basis_band_matrix`` on the card against the CPU port, rtol 1e-6
    (atol 1e-7 x max: sums of 64 float32 terms in another order), and
    ``make_photo_z_logdensity``'s value and gradient on the card against
    the CPU port on the same vectors, for the exact projection and for the
    8192-point grid (built on the CPU, then gathered and interpolated on
    the card): values rtol 1e-5, gradients rtol 1e-4 with atol 1e-4 (the
    card's exp, sigmoid and softmax round differently by an ulp or two);
    TF32 off for float32 matmuls."""
    from celeste_tpu_torch.inference.hmc import value_and_grad
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, band_matrix_grid, make_photo_z_logdensity,
        project_to_bands, sdss_like_filterbank,
    )
    from celeste_tpu_torch.quasar.photometry import basis_band_matrix

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    basis, filt = QuasarBasis.default(), sdss_like_filterbank(n_pts=64)
    z = torch.linspace(0.0, 5.99, 37)
    want = basis_band_matrix(basis, filt, z)
    got = basis_band_matrix(basis.to(cuda), filt.to(cuda), z.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7 * float(want.abs().max()))

    k = basis.n_basis
    w0 = torch.full((k,), 1.0 / k)
    flux = project_to_bands(basis, filt, w0, 2.0, 1.7).numpy()
    err = 0.03 * np.abs(flux) + 1e-5
    rng = np.random.default_rng(5)
    vec0 = np.concatenate([[np.log(1.7 / (6.0 - 1.7))], np.zeros(k - 1), [np.log(2.0)]])
    v = (vec0[None] + 0.3 * rng.normal(size=(64, k + 1))).astype(np.float32)
    v[:4, 0] = [30.0, 30.0, -30.0, -30.0]            # z at z_max and at 0
    v = torch.as_tensor(v)
    grid = band_matrix_grid(basis, filt)
    for n_grid, g in ((0, None), (8192, grid)):
        cfg = PhotoZConfig(flux_grid_n=n_grid)
        lv, lg = value_and_grad(make_photo_z_logdensity(basis, filt, flux, err, cfg, grid=g), v)
        g_card = None if g is None else g._replace(table=g.table.to(cuda))
        cv, cg = value_and_grad(make_photo_z_logdensity(basis.to(cuda), filt.to(cuda), flux, err,
                                                        cfg, grid=g_card), v.to(cuda))
        assert cv.is_cuda and bool(torch.isfinite(cv).all() and torch.isfinite(cg).all())
        torch.testing.assert_close(cv.cpu(), lv, rtol=1e-5, atol=0.0)
        torch.testing.assert_close(cg.cpu(), lg, rtol=1e-4, atol=1e-4)


def test_resumed_star_single_is_bitwise_on_the_card(cuda, tmp_path):
    """``run_experiment`` of star_single (MH and HMC, 16 chains, 4 segments)
    stopped after segment 2 and resumed equals the unbroken run bitwise,
    and the runs launched K1."""
    from celeste_tpu_torch.run import main

    for sampler in ("mh", "hmc"):
        base = ["config=star_single", f"sampler={sampler}", "n_chains=16", "n_warmup=20",
                "n_leapfrog=4", "checkpoint_every=10"]
        mf.reset_launch_counts()
        full = main(base + ["n_steps=40", f"out={tmp_path}/{sampler}_full"])
        assert mf.launch_counts()["mog_field_loglik_fwd"] > 0
        main(base + ["n_steps=20", f"out={tmp_path}/{sampler}_half"])
        resumed = main(base + ["n_steps=40", f"resume={tmp_path}/{sampler}_half.ckpt.npz",
                               f"out={tmp_path}/{sampler}_resumed"])
        for key in ("samples", "mean", "rhat"):
            np.testing.assert_array_equal(resumed[key], full[key])


def test_photo_z_run_keeps_tf32_off(cuda):
    """A short config-4 ladder on the card: finite draws, and the float32
    matmul settings still exclude TF32 after it."""
    from celeste_tpu_torch.quasar import (
        PhotoZConfig, QuasarBasis, project_to_bands, run_photo_z, sdss_like_filterbank,
    )

    basis, filt = QuasarBasis.default(), sdss_like_filterbank(n_pts=64)
    flux = project_to_bands(basis, filt, torch.full((4,), 0.25), 2.0, 2.0).numpy()
    out = run_photo_z(0, basis, filt, flux, 0.03 * np.abs(flux) + 1e-5,
                      PhotoZConfig(n_temps=4, n_steps=20, n_warmup=5, n_systems=2,
                                   inner="hmc_adaptive", pt_warmup_steps=10), device="cuda")
    assert out["z"].is_cuda and bool(torch.isfinite(out["z"]).all())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# the stamp pipeline's conditional posteriors (celeste_tpu_torch/pipeline.py)
# ---------------------------------------------------------------------------

def _pipeline_field(device, n_extra_gal=0, n_extra_star=0, seed=0):
    """The ``pipeline`` config's field on the card with its three sources
    as candidates, plus extra candidates (galaxies and stars at random
    spots), as rectangular states, kind flags and the port's
    ``Conditional``."""
    from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.pipeline import Conditional

    scene, srcs = pipeline_scene(CONFIGS["pipeline"], device)
    rng = np.random.default_rng(seed)
    rects, flags = [], []
    for s in srcs:
        r = np.zeros(7, np.float32)
        r[:2], r[2] = scene.wcs.equa2duas(s["u"]), np.log(s["flux"][2])
        r[3:] = [0.0, 0.0, 0.0, 0.5] if s["type"] == "star" else [-0.4, np.log(1.8), 0.4, 0.7]
        rects.append(r)
        flags.append(s["type"] == "star")
    for k in range(n_extra_gal + n_extra_star):
        gal = k < n_extra_gal
        r = np.concatenate([rng.uniform(-5.0, 5.0, 2), [np.log(rng.uniform(5.0, 40.0))],
                            [0.0, np.log(rng.uniform(0.5, 2.0)), 0.5, rng.uniform(0, 3)]])
        rects.append(r.astype(np.float32))
        flags.append(not gal)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    return scene, np.stack(rects), np.array(flags), Conditional(scene.stamps, [0], 1, priors)


def _per_row_sky_logdensity(cond, kind, probs, folded, is_star, x):
    """The plain per-row-sky form of the folded conditional: each row's
    others rendered by K7's plain version into its own sky, the row's own
    components through K1's plain version against that [R, P] sky."""
    from celeste_tpu_torch.pipeline import kind_logprior

    (fixed, owner), = folded
    px, py, counts, sky, mask = cond.pds[0]
    k = x.shape[0] // len(probs)
    cands = torch.as_tensor(np.repeat(probs, k), device=x.device)
    keep = (owner[None, :] != cands[:, None]).to(torch.float32)
    rows = x.shape[0]
    eff = mf._render_torch(keep * fixed[0], *(f.expand(rows, -1) for f in fixed[1:]), px, py,
                           sky)
    flags = (torch.as_tensor(np.repeat(is_star, k), device=x.device)
             if kind == "mixed" else None)
    own = cond._own_planes(kind, x, cond.stamps[0], 0, flags)
    return (mf._loglik_torch(*own, px, py, counts, eff, mask)
            + kind_logprior(cond.priors, cond.n_bands, kind, x, flags))


# (kind, extra galaxies, extra stars, rows per problem): the classify
# sweep's Adam batch (mixed, 2N rows) and its Hessian batch (15 rows per
# problem), the type switch's blocks (8 chains per candidate), and a row of
# ~390 components at 1100 rows (8 chains per block, K1-bwd's ~400 cap)
FOLDED_CASES = [("mixed", 0, 0, 1), ("mixed", 0, 2, 15), ("star", 0, 0, 8),
                ("galaxy", 0, 0, 8), ("star", 7, 0, 110)]


@pytest.mark.parametrize("kind,n_gal,n_star,k", FOLDED_CASES)
def test_folded_conditional_through_k1_matches_per_row_sky(cuda, kind, n_gal, n_star, k):
    """The pipeline's conditional log density through K1-fwd and K1-bwd
    (one launch each) against the plain per-row-sky form: values rtol 2e-6,
    atol 0.5; gradients rtol 5e-4, atol 5e-2."""
    _, rects, flags, cond = _pipeline_field(cuda, n_gal, n_star)
    n = len(rects)
    folded = cond.fold(rects, flags, np.ones(n, bool))
    if kind == "mixed":
        probs, is_star, width = np.repeat(np.arange(n), 2), [True, False] * n, 7
    else:
        probs = np.arange(min(n, 10))
        is_star, width = None, 3 if kind == "star" else 7
    rng = np.random.default_rng(4)
    x = np.repeat(rects[probs][:, :width], k, axis=0)
    x = torch.as_tensor((x + 0.02 * rng.normal(size=x.shape)).astype(np.float32), device=cuda)
    logd = cond.logdensity(kind, probs, folded, is_star=is_star)
    before = mf.launch_counts()
    xr = x.clone().requires_grad_(True)
    val = logd(xr)
    (grad,) = torch.autograd.grad(val.sum(), xr)
    after = mf.launch_counts()
    assert after["mog_field_loglik_fwd"] - before["mog_field_loglik_fwd"] == 1
    assert after["mog_field_loglik_bwd"] - before["mog_field_loglik_bwd"] == 1
    xp = x.clone().requires_grad_(True)
    want = _per_row_sky_logdensity(cond, kind, probs, folded, is_star, xp)
    (gwant,) = torch.autograd.grad(want.sum(), xp)
    torch.testing.assert_close(val.detach(), want.detach(), rtol=2e-6, atol=0.5)
    torch.testing.assert_close(grad, gwant, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["star", "galaxy"])
def test_difference_hessian_through_k1_matches_autodiff(cuda, kind):
    """1/2 log det(-H) of a candidate's conditional at its MAP: the port's
    central differences of K1-bwd's gradient against ``torch.func.hessian``
    of the plain per-row-sky form on the card, within 0.01 nats."""
    from celeste_tpu_torch.inference.map_fit import map_fit
    from celeste_tpu_torch.inference.model_select import hessian_fd

    _, rects, flags, cond = _pipeline_field(cuda)
    folded = cond.fold(rects, flags, np.ones(3, bool))
    cand, width = (0, 3) if kind == "star" else (2, 7)
    logd = cond.logdensity(kind, [cand], folded)
    x0 = torch.as_tensor(rects[cand:cand + 1, :width], device=cuda)
    x_map, _ = map_fit(logd, x0, n_steps=250)
    _, h = hessian_fd(logd, x_map)

    def plain(v):
        return _per_row_sky_logdensity(cond, kind, [cand], folded, None, v[None])[0]

    h_ad = torch.func.hessian(plain)(x_map[0].detach())
    got = 0.5 * float(torch.linalg.slogdet(-h[0].double())[1])
    want = 0.5 * float(torch.linalg.slogdet(-(h_ad + h_ad.T).double() / 2)[1])
    assert abs(got - want) < 0.01, (got, want)


def test_pipeline_catalog_at_full_settings(cuda):
    """tests/test_pipeline.py's run uncut on the card: its ``mixed_field``
    (the ``pipeline`` config's scene) at its settings (five detection
    rounds, 250-step MAP fits, the type switch's 300 steps of 8 chains, 8
    chains of 150 warmup and 250 ChEES steps, seed 3), held to that file's
    gates (:38-96), with K1 and K7 launched.  The CPU's run of it is cut in
    steps (tests/test_torch_pipeline_catalog.py)."""
    from celeste_tpu_torch.catalog import catalog_accuracy, reference_from_sources
    from celeste_tpu_torch.experiments import CONFIGS, pipeline_scene
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
    from celeste_tpu_torch.pipeline import PipelineConfig, run_pipeline

    scene, srcs = pipeline_scene(CONFIGS["pipeline"], cuda)
    cfg = PipelineConfig(max_sources=5, n_chains=8, n_warmup=150, n_steps=250, map_steps=250,
                         seed=3, detection_min_separation=7)
    before = mf.launch_counts()
    catalog, art = run_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg,
                                priors=SourcePriors(flux=FluxPrior(3.2, 2.0)))
    after = mf.launch_counts()
    assert all(after[k] > before[k] for k in after), (before, after)
    assert art["n_sources"] == 3
    assert art["samples"].shape == (8, 250, 3 + 3 + 7) and np.isfinite(art["samples"]).all()
    assert sorted(e.kind for e in catalog) == ["galaxy", "star", "star"], catalog
    rep = catalog_accuracy(catalog, reference_from_sources(srcs, scene.wcs, band_slots=[2]),
                           max_sep_arcsec=1.0)
    assert rep["completeness"] == 1.0 and rep["purity"] == 1.0 and rep["kind_accuracy"] == 1.0
    assert rep["pos_rms_arcsec"] < 0.2 and abs(rep["flux_rel_bias"]) < 0.2, rep
    assert 0.05 < rep["pos_z_rms"] < 6.0 and 0.05 < rep["flux_z_rms"] < 6.0, rep
    truth = sorted(s["flux"][2] for s in srcs)
    est = sorted(float(e.flux_mean[0]) for e in catalog)
    assert all(abs(e - t) / t < 0.25 for t, e in zip(truth, est)), (truth, est)
    truth = sorted(tuple(np.round(scene.wcs.equa2duas(s["u"]), 1)) for s in srcs)
    est = sorted(tuple(np.round(e.du_mean, 1)) for e in catalog)
    assert all(np.hypot(t[0] - e[0], t[1] - e[1]) < 0.4 for t, e in zip(truth, est)), (truth,
                                                                                     est)
    gal = [e for e in catalog if e.kind == "galaxy"][0]
    assert 0.5 < gal.extras["sigma_mean"] < 4.0 and 0.1 < gal.extras["ab_mean"] < 1.0


@pytest.mark.parametrize("n_rows", [8, 1100])
def test_k1_component_cap_is_the_kernels(cuda, n_rows):
    """A row's components have no cap: the pipeline's galaxy conditional
    with 8 extra galaxies folded in (486 components a row: its own 48, 9
    galaxies' 432 and 2 stars' 6) runs at 8 rows (one chain per block) both
    ways, against the plain per-row-sky form within the gates of the folded
    test.  At 1100 rows (8 chains per block) K1-fwd stages the rows whole
    and K1-bwd, past its whole-row staging there, takes the staged path;
    values and gradients equal the 8-row ones within the same gates."""
    _, rects, flags, cond = _pipeline_field(cuda, n_extra_gal=8)
    folded = cond.fold(rects, flags, np.ones(len(rects), bool))
    logd = cond.logdensity("galaxy", [2], folded)
    rng = np.random.default_rng(5)
    x8 = np.repeat(rects[2:3], 8, axis=0)
    x8 = torch.as_tensor((x8 + 0.02 * rng.normal(size=x8.shape)).astype(np.float32), device=cuda)
    x = x8.repeat(n_rows // 8 + 1, 1)[:n_rows].contiguous().requires_grad_(True)
    val = logd(x)
    if n_rows == 8:
        (grad,) = torch.autograd.grad(val.sum(), x)
        xp = x8.clone().requires_grad_(True)
        want = _per_row_sky_logdensity(cond, "galaxy", [2], folded, None, xp)
        (gwant,) = torch.autograd.grad(want.sum(), xp)
        torch.testing.assert_close(val.detach(), want.detach(), rtol=2e-6, atol=0.5)
        torch.testing.assert_close(grad, gwant, **GRAD_TOL)
    else:
        assert mf.k1_geometry(1100, 1024)[0] == 8 and mf.components_staged("bwd", 8, 486)
        (grad,) = torch.autograd.grad(val.sum(), x)
        x8 = x8.clone().requires_grad_(True)
        val8 = logd(x8)
        (grad8,) = torch.autograd.grad(val8.sum(), x8)
        torch.testing.assert_close(val[:8].detach(), val8.detach(), rtol=2e-6, atol=0.5)
        torch.testing.assert_close(grad[:8], grad8, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the pixel-set mode and the field pipeline (ROADMAP §1 items 1-2)
# ---------------------------------------------------------------------------

# (sets, rows per set, components, cutout side): the field's candidate
# cutouts (24x24) at R = 1 (detection, K7's cutout lambdas) and R = 2 (the
# classify batch), and its group cutouts (48x48 for ``field``, 32x32 for
# ``field_survey``) at R = 8 and 32 chains with two and three galaxy-wide
# slots; a set count that leaves a partial block of chains
PIXEL_SET_CASES = [(16, 1, 48, 24), (16, 2, 48, 24), (7, 1, 3, 24), (4, 8, 96, 48),
                   (4, 32, 96, 48), (53, 8, 144, 32), (4, 32, 144, 32), (3, 6, 48, 24)]
LAM_TOL = dict(rtol=1e-5, atol=1e-3)


def _set_problem(cuda, s, r, c, side):
    planes, sets = mf.random_pixel_set_problem(s, r, c, side, seed=s * r + c)
    planes = [torch.as_tensor(a, device=cuda) for a in planes]
    sets = [torch.as_tensor(a, device=cuda) for a in sets]
    return planes, sets, mf.rows_of_sets(tuple(sets), s * r)


@pytest.mark.parametrize("s,r,c,side", PIXEL_SET_CASES)
def test_pixel_set_kernels_match_plain(cuda, s, r, c, side):
    """K1-fwd (centered and not), K1-bwd and K7 on [S, P] pixel sets
    against their plain versions on the sets expanded to rows, padding
    lanes included, each twice bitwise; the geometry keeps a block's chains
    in one set."""
    planes, sets, rows = _set_problem(cuda, s, r, c, side)
    b = s * r
    cb, _ = mf.k1_geometry(b, sets[0].shape[1], s)
    assert r % cb == 0 and mf.k7_geometry(b, sets[0].shape[1], s)[0] in (1, 2, 4, 8)
    for centered in (False, True):
        got = mf.loglik_fwd_cuda(*planes, *sets, centered=centered)
        assert torch.equal(got, mf.loglik_fwd_cuda(*planes, *sets, centered=centered))
        torch.testing.assert_close(got, mf._loglik_torch(*planes, *rows, centered=centered),
                                   **TOL["galaxy"])
    g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32), device=cuda)
    got = mf.loglik_bwd_cuda(*planes, *sets, g)
    again = mf.loglik_bwd_cuda(*planes, *sets, g)
    for a, a2, w in zip(got, again, mf._loglik_bwd_torch(*planes, *rows, g)):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, w, **GRAD_TOL)
    lam = mf.render_cuda(*planes, sets[0], sets[1], sets[3])
    assert torch.equal(lam, mf.render_cuda(*planes, sets[0], sets[1], sets[3]))
    torch.testing.assert_close(lam, mf._render_torch(*planes, rows[0], rows[1], rows[3]),
                               **LAM_TOL)
    assert bool((lam[:, side * side:] == 1.0).all())


def test_pixel_set_entry_points_launch_the_kernels(cuda):
    """``mog_field_loglik`` and ``mog_field_render`` take [S, P] pixel data
    through the same functions: one K1-fwd and one K1-bwd launch (autograd)
    and one K7, equal to the CPU's plain mode."""
    planes, sets, _ = _set_problem(cuda, 5, 4, 48, 24)
    before = mf.launch_counts()
    leaves = [p.clone().requires_grad_(True) for p in planes]
    val = mf.mog_field_loglik(*leaves, sets, centered=True)
    grads = torch.autograd.grad(val.sum(), leaves)
    lam = mf.mog_field_render(*planes, sets)
    after = mf.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "mog_field_loglik_fwd": 1, "mog_field_loglik_bwd": 1, "mog_field_render": 1}
    cpu = [p.cpu().requires_grad_(True) for p in planes]
    cpu_sets = [t.cpu() for t in sets]
    want = mf.mog_field_loglik(*cpu, cpu_sets, centered=True)
    want_g = torch.autograd.grad(want.sum(), cpu)
    torch.testing.assert_close(val.detach().cpu(), want.detach(), **TOL["galaxy"])
    for a, w in zip(grads, want_g):
        torch.testing.assert_close(a.cpu(), w, **GRAD_TOL)
    torch.testing.assert_close(lam.cpu(), mf.mog_field_render(*(p.cpu() for p in planes),
                                                              cpu_sets), **LAM_TOL)


def test_pixel_set_wrappers_reject_bad_sets(cuda):
    planes, sets, _ = _set_problem(cuda, 3, 2, 3, 24)
    with pytest.raises(ValueError, match="pixel sets"):
        mf.loglik_fwd_cuda(*(p[:5].contiguous() for p in planes), *sets)
    with pytest.raises(ValueError, match="shape"):
        mf.loglik_fwd_cuda(*planes, sets[0][:2].contiguous(), *sets[1:])
    with pytest.raises(ValueError, match="pixel sets"):
        mf.render_cuda(*(p[:4].contiguous() for p in planes), sets[0], sets[1], sets[3])


@pytest.mark.parametrize("kind", ["star", "galaxy", "mixed"])
def test_field_conditional_rows_through_k1_match_the_cpu(cuda, kind):
    """The field's conditional log densities (``field._Frames``) on the
    mixed frame's candidate cutouts, at the type switch's row layout (8
    chains a candidate, R = 8) and the classify batch's (a star and a galaxy
    row a candidate, R = 2): value and gradient through K1 on the card
    against the CPU's plain pixel-set mode."""
    from celeste_tpu_torch.field import _cut_origin, _Frames, _gather_cutouts
    from celeste_tpu_torch.kernels.mog_field import pad_pixel_sets
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    import torch_field_workers as w

    scene, srcs = w.two_group_frame(cuda)
    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
    stamp = scene.stamps[0]
    du = np.stack([scene.wcs.equa2duas(s_["u"]) for s_ in srcs])
    pos = stamp.duas2pixel(torch.as_tensor(du, dtype=torch.float32, device=cuda)).cpu().numpy()
    origins = np.array([_cut_origin(x_, y_, 24, *stamp.counts.shape) for x_, y_ in pos])
    counts, sky, mask = (t.cpu().numpy().astype(np.float64) for t in (stamp.counts, stamp.sky,
                                                                       stamp.mask))
    cut = _gather_cutouts(origins, 24, counts, sky, mask, device=cuda)
    rng = np.random.default_rng(3)
    rect = np.concatenate([du, np.log([[s_["flux"][2]] for s_ in srcs]),
                           np.tile([0.0, 0.0, 0.0, 0.5], (3, 1))], axis=1).astype(np.float32)
    if kind == "mixed":
        x = np.repeat(rect, 2, axis=0)
        is_star = [True, False] * 3
    else:
        x = np.repeat(rect[:, :3] if kind == "star" else rect, 8, axis=0)
        is_star = None
    x = (x + 0.01 * rng.normal(size=x.shape)).astype(np.float32)
    out = {}
    for device in (cuda, torch.device("cpu")):
        fr = _Frames([stamp.to(device)], [0], 1, priors)
        sets = [pad_pixel_sets(*(t.to(device) for t in cut))]
        xt = torch.as_tensor(x, device=device).requires_grad_(True)
        val = fr.logdensity(kind, sets, is_star)(xt)
        (grad,) = torch.autograd.grad(val.sum(), xt)
        out[device.type] = (val.detach().cpu(), grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-6, atol=1.0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=5e-4, atol=5e-2)


def _small_field(cuda, **over):
    """tests/test_field.py's two-group frame through the field pipeline at
    that file's ``_small_cfg`` settings, uncut."""
    from celeste_tpu_torch.field import FieldConfig, run_field_pipeline

    import torch_field_workers as w

    scene, srcs = w.two_group_frame(cuda)
    base = dict(sample=True, seed=4, n_chains=12, probe_warmup=32, probe_steps=16, n_warmup=48,
                n_steps=96, max_leapfrog=24, map_steps=150, type_switch=False, group_cut=32,
                group_margin_px=8)
    cat, art = run_field_pipeline(scene.stamps[0], band=0, n_bands=1,
                                  cfg=FieldConfig(**(base | over)), priors=w.PRIORS)
    return scene, srcs, cat, art


def _recovered(scene, srcs, cat, slots=(2,), pos_tol=0.4, flux_tol=0.15):
    truth = sorted((tuple(np.round(scene.wcs.equa2duas(s_["u"]), 1)),
                    tuple(s_["flux"][b] for b in slots)) for s_ in srcs)
    est = sorted((tuple(np.round(e.du_mean, 1)), tuple(float(f) for f in e.flux_mean))
                 for e in cat)
    for (tu, tf), (eu, ef) in zip(truth, est):
        assert np.hypot(tu[0] - eu[0], tu[1] - eu[1]) < pos_tol, (truth, est)
        for t, e in zip(tf, ef):
            assert abs(e - t) / t < flux_tol, (truth, est)


def test_field_posterior_recovery_at_full_settings(cuda):
    """tests/test_field.py:206 uncut on the card: 2 groups, 3 sources,
    positions within 0.4'', fluxes within 15%, each group's R-hat < 1.1
    and divergence < 0.05; K1 launched."""
    before = mf.launch_counts()["mog_field_loglik_fwd"]
    scene, srcs, cat, art = _small_field(cuda)
    assert mf.launch_counts()["mog_field_loglik_fwd"] > before
    assert art["n_groups"] == 2 and len(cat) == 3
    _recovered(scene, srcs, cat)
    for d in art["diagnostics"]:
        assert d["rhat_max"] < 1.1 and d["divergence_rate"] < 0.05, d


def test_field_multiband_joint_at_full_settings(cuda):
    """tests/test_field.py:350 uncut on the card: two bands jointly recover
    each band's fluxes and tighten the positions against band 2 alone."""
    from celeste_tpu_torch.data.synthetic import make_synthetic_stamp, star_source
    from celeste_tpu_torch.field import FieldConfig, run_field_pipeline

    import torch_field_workers as w

    srcs = [star_source(u=(30.0 - 8 * w.ASU / w.COSD, 10.0 - 8 * w.ASU), flux_r=55.0),
            star_source(u=(30.0 + 8 * w.ASU / w.COSD, 10.0 + 8 * w.ASU), flux_r=45.0)]
    scene = make_synthetic_stamp(srcs, shape=(64, 64), bands=(1, 2), seed=31, device=cuda)
    cfg = FieldConfig(sample=True, seed=4, n_chains=12, probe_warmup=32, probe_steps=16,
                      n_warmup=48, n_steps=96, max_leapfrog=24, map_steps=150,
                      type_switch=False, group_cut=32, group_margin_px=8)
    cat2, art2 = run_field_pipeline(scene.stamps, band=[0, 1], n_bands=2, cfg=cfg,
                                    priors=w.PRIORS)
    assert len(cat2) == 2 and all(e.kind == "star" for e in cat2)
    _recovered(scene, srcs, cat2, slots=(1, 2))
    for d in art2["diagnostics"]:
        assert d["rhat_max"] < 1.1 and d["divergence_rate"] < 0.05, d
    cat1, _ = run_field_pipeline(scene.stamps[1], band=0, n_bands=1, cfg=cfg, priors=w.PRIORS)
    assert len(cat1) == 2
    du_std2 = np.mean([np.mean(e.du_std) for e in cat2])
    du_std1 = np.mean([np.mean(e.du_std) for e in cat1])
    assert du_std2 < du_std1, (du_std2, du_std1)


def test_field_segmented_sampling_matches_unsegmented_in_distribution(cuda):
    """tests/test_field.py:386's settings on the card.  In the port a
    segmented run draws from its segments' streams and an unsegmented one
    from one stream per phase, so the two agree in distribution only (JAX
    pins its key streams across segments): the same catalog kinds, means
    within the larger posterior sd, spreads within a factor 1.34, R-hat <
    1.15 and divergence < 0.05 per group."""
    kw = dict(n_chains=8, probe_warmup=20, probe_steps=8, n_warmup=20, n_steps=20, map_steps=60)
    _, _, cat_m, art_m = _small_field(cuda, **kw)
    _, _, cat_s, art_s = _small_field(cuda, sample_segment=8, warmup_window=9, **kw)
    assert art_m["samples"].shape == art_s["samples"].shape and len(cat_m) == len(cat_s)
    for em, es in zip(cat_m, cat_s):
        assert em.kind == es.kind
        sf = max(float(em.flux_std[0]), float(es.flux_std[0]))
        assert abs(float(em.flux_mean[0]) - float(es.flux_mean[0])) < sf
        du_tol = max(float(np.max(em.du_std)), float(np.max(es.du_std)), 0.005)
        assert np.hypot(*(np.asarray(em.du_mean) - es.du_mean)) < du_tol
        assert 1 / 1.34 < float(em.flux_std[0]) / max(float(es.flux_std[0]), 1e-9) < 1.34
    for d in art_s["diagnostics"]:
        assert d["rhat_max"] < 1.15 and d["divergence_rate"] < 0.05, d


def test_field_scale_accuracy_sampled(cuda):
    """tests/test_field.py:487 on the card with the posterior stage the JAX
    CPU lane could not afford: the 256x1024 survey frame, ~60 sources,
    ``survey_scene_cfg()``; completeness, purity and kind accuracy >= 0.9,
    matches >= 0.9 of the sources (the JAX test asks for all), position RMS
    < 0.1'', |flux bias| < 0.05, position and flux z-RMS in [0.7, 1.4]."""
    from celeste_tpu_torch.bench.field_scale import (
        accuracy_report, make_survey_scene, survey_scene_cfg,
    )
    from celeste_tpu_torch.field import run_field_pipeline

    import torch_field_workers as w

    scene, srcs = make_survey_scene(device=cuda)
    assert len(srcs) >= 50 and tuple(scene.stamps[0].counts.shape) == (256, 1024)
    cat, art = run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=survey_scene_cfg(),
                                  priors=w.PRIORS)
    rep = accuracy_report(cat, scene, srcs)
    assert rep["completeness"] >= 0.9 and rep["purity"] >= 0.9, rep
    assert rep["kind_accuracy"] >= 0.9, rep
    assert rep["pos_rms_arcsec"] < 0.1 and abs(rep["flux_rel_bias"]) < 0.05, rep
    assert rep["n_matched"] >= 0.9 * len(srcs), rep
    assert 0.7 <= rep["pos_z_rms"] <= 1.4 and 0.7 <= rep["flux_z_rms"] <= 1.4, rep


# ---------------------------------------------------------------------------
# K1 and K7 past the whole-row staging: the staged path (no component cap)
# ---------------------------------------------------------------------------

# a row's components: 400 is K1-bwd's whole-row limit at 8 chains a block;
# 960 is a field group of 20 sources (S_max galaxy-wide slots of 48), 2400
# one of 50
LARGE_C = (400, 960, 2400)
# (sets, rows per set, cutout side): the stamp mode ([1, P]) at B = 64 and
# 1024 on 48x48, and the pixel sets of field_survey's groups ([424, C] x 53
# sets of 32x32) and field's ([128, C] x 4 sets of 48x48)
LARGE_C_LAYOUTS = ((1, 64, 48), (1, 1024, 48), (53, 8, 32), (4, 32, 48))


def _plain_rows(plain, planes, pixels, extra=(), chunk=32, **kw):
    """A plain version over chunks of rows (a [1024, 2400, 2304]
    intermediate is 22 GB whole), the pixel sets expanded to rows."""
    b = planes[0].shape[0]
    rows = mf.rows_of_sets(tuple(pixels), b)
    outs = []
    for c0 in range(0, b, chunk):
        sl = slice(c0, c0 + chunk)
        pix = [t if t.shape[0] == 1 else t[sl] for t in rows]
        outs.append(plain(*(p[sl] for p in planes), *pix, *(e[sl] for e in extra), **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _large_c_problem(cuda, n_sets, r, c, side):
    planes, sets = mf.random_pixel_set_problem(n_sets, r, c, side, seed=n_sets + r + c)
    return ([torch.as_tensor(a, device=cuda) for a in planes],
            [torch.as_tensor(a, device=cuda) for a in sets])


def _other_path_bitwise(monkeypatch, fn, kernel, b, c, n_sets, pix_pad, args, got, **kw):
    """Where both paths fit, the path the wrapper did not take gives the
    same bits (each pixel adds its components in index order either way)."""
    geometry = mf.k7_geometry if kernel == "render" else mf.k1_geometry
    cb = geometry(b, pix_pad, n_sets)[0]
    if mf.whole_row_smem(kernel, cb, c) > mf.SMEM_OPTIN or (kernel == "bwd" and c <= 4):
        return False
    with monkeypatch.context() as m:
        _force_path(m, not mf.components_staged(kernel, cb, c))
        other = fn(*args, **kw)
    if isinstance(got, tuple):
        assert all(torch.equal(a, o) for a, o in zip(got, other)), kernel
    else:
        assert torch.equal(got, other), kernel
    return True


@pytest.mark.parametrize("layout", LARGE_C_LAYOUTS)
@pytest.mark.parametrize("c", LARGE_C)
def test_large_component_rows_match_plain(cuda, monkeypatch, c, layout):
    """K1-fwd (centered both ways), K1-bwd and K7 at 400, 960 and 2400
    components a row, in stamp mode and on the field's pixel sets, against
    their plain versions (fwd rtol 2e-6 + atol 0.5, bwd rtol 5e-4 + atol
    5e-2, K7 rtol 1e-5 + atol 1e-3); one launch a call; two calls bitwise
    equal; where the whole-row path also fits, the other path's bits."""
    n_sets, r, side = layout
    planes, sets = _large_c_problem(cuda, n_sets, r, c, side)
    b, pix_pad = n_sets * r, sets[0].shape[1]
    g = torch.as_tensor(np.random.default_rng(c).normal(size=b).astype(np.float32), device=cuda)
    render_sets = (sets[0], sets[1], sets[3])
    for centered in (False, True):
        before = mf.launch_counts()["mog_field_loglik_fwd"]
        got = mf.loglik_fwd_cuda(*planes, *sets, centered=centered)
        assert mf.launch_counts()["mog_field_loglik_fwd"] == before + 1
        assert torch.equal(got, mf.loglik_fwd_cuda(*planes, *sets, centered=centered))
        torch.testing.assert_close(got, _plain_rows(mf._loglik_torch, planes, sets,
                                                    centered=centered), **TOL["star"])
        _other_path_bitwise(monkeypatch, mf.loglik_fwd_cuda, "fwd", b, c, n_sets, pix_pad,
                            (*planes, *sets), got, centered=centered)
    before = mf.launch_counts()["mog_field_loglik_bwd"]
    got = mf.loglik_bwd_cuda(*planes, *sets, g)
    assert mf.launch_counts()["mog_field_loglik_bwd"] == before + 1
    again = mf.loglik_bwd_cuda(*planes, *sets, g)
    want = _plain_rows(mf._loglik_bwd_torch, planes, sets, extra=(g,))
    for name, a, a2, w in zip("amp mx my pa pb pc".split(), got, again, want):
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a, w, **GRAD_TOL, msg=name)
    _other_path_bitwise(monkeypatch, mf.loglik_bwd_cuda, "bwd", b, c, n_sets, pix_pad,
                        (*planes, *sets, g), got)
    before = mf.launch_counts()["mog_field_render"]
    lam = mf.render_cuda(*planes, *render_sets)
    assert mf.launch_counts()["mog_field_render"] == before + 1
    assert torch.equal(lam, mf.render_cuda(*planes, *render_sets))
    torch.testing.assert_close(lam, _plain_rows(mf._render_torch, planes, render_sets),
                               **LAM_TOL)
    _other_path_bitwise(monkeypatch, mf.render_cuda, "render", b, c, n_sets, pix_pad,
                        (*planes, *render_sets), lam)


@pytest.mark.parametrize("s,r,c,side", PIXEL_SET_CASES + [(1, 64, 3, 25), (1, 64, 48, 31),
                                                          (1, 4096, 48, 25), (1, 1024, 126, 48)])
def test_staged_path_gives_the_whole_row_bits(cuda, monkeypatch, s, r, c, side):
    """At every phase-g pixel-set shape and at [1, P] stamp shapes (a star's
    3 components, a galaxy's 48, config 5's 126), which take the whole-row
    path, the staged path asked for gives the same bits: K1-fwd both ways,
    K1-bwd (C > 4) and K7."""
    planes, sets, _ = _set_problem(cuda, s, r, c, side)
    b, pix_pad = s * r, sets[0].shape[1]
    g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32), device=cuda)
    for centered in (False, True):
        got = mf.loglik_fwd_cuda(*planes, *sets, centered=centered)
        assert _other_path_bitwise(monkeypatch, mf.loglik_fwd_cuda, "fwd", b, c, s, pix_pad,
                                   (*planes, *sets), got, centered=centered)
    got = mf.loglik_bwd_cuda(*planes, *sets, g)
    assert _other_path_bitwise(monkeypatch, mf.loglik_bwd_cuda, "bwd", b, c, s, pix_pad,
                               (*planes, *sets, g), got) == (c > 4)
    lam = mf.render_cuda(*planes, sets[0], sets[1], sets[3])
    assert _other_path_bitwise(monkeypatch, mf.render_cuda, "render", b, c, s, pix_pad,
                               (*planes, sets[0], sets[1], sets[3]), lam)


def test_crowded_field_group_runs_through_k1(cuda):
    """The field's group log density (``field._group_logdensity``) of a
    galaxy cluster linked into one group of 20 sources (960 components a
    row, ``bench.field_scale.cluster_group``) at the field's 32 chains:
    one K1-fwd and one K1-bwd launch (the backward on the staged path), value
    and gradient equal to the CPU's plain mode at K1's gates."""
    from celeste_tpu_torch import field as tfield
    from celeste_tpu_torch.bench.field_scale import cluster_group
    from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors

    priors = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))

    out = {}
    for device in ("cpu", cuda):
        scene, _, rects, is_star, pixels = cluster_group(device)
        fr = tfield._Frames([scene.stamps[0]], [0], 1, priors)
        sets = [mf.pad_pixel_sets(*(torch.as_tensor(a[None], device=device) for a in pixels))]
        logd = tfield._group_logdensity(fr, sets, torch.as_tensor(is_star[None], device=device),
                                        torch.ones(1, len(is_star), dtype=torch.bool,
                                                   device=device))
        x = (rects.reshape(1, -1)
             + 0.01 * np.random.default_rng(3).normal(size=(32, rects.size))).astype(np.float32)
        xt = torch.tensor(x, device=device, requires_grad=True)
        before = mf.launch_counts()
        val = logd(xt)
        (grad,) = torch.autograd.grad(val.sum(), xt)
        after = mf.launch_counts()
        out[str(device)] = (val.detach().cpu(), grad.cpu(),
                            {k: after[k] - before[k] for k in after})
    pix_pad = -(-len(pixels[0]) // mf.LANE) * mf.LANE
    assert mf.components_staged("bwd", mf.k1_geometry(32, pix_pad)[0], 960)
    assert out["cuda:0"][2] == {"mog_field_loglik_fwd": 1, "mog_field_loglik_bwd": 1,
                                "mog_field_render": 0}
    torch.testing.assert_close(out["cuda:0"][0], out["cpu"][0], rtol=2e-6, atol=0.5)
    torch.testing.assert_close(out["cuda:0"][1], out["cpu"][1], **GRAD_TOL)
