"""The port's tiled field module (``celeste_tpu_torch.kernels.tiled_field``)
and tile maps on the CPU, where the kernels' plain PyTorch versions run,
against the JAX package on identical inputs.

Tile maps, tiled pixels, occupancy buckets and support radii must be equal
arrays.  Planes: rtol 1e-5, atol 1e-5 (the stamp planes' gate).  Tiled
log-likelihoods: rtol 2e-6, atol 1.0; gradients rtol 5e-4, atol 0.1
(tests/test_tiled_field.py:97, :129).  The plain K3/K4 pair against the JAX
Pallas pair in interpret mode: values rtol 2e-5, atol 2e-2; cotangents
rtol 2e-4, atol 5e-3 (tests/test_tiled_field.py:308-315).  The kernels
themselves are held against the same plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.bench.config5 import build_config5 as j_build_config5
from celeste_tpu.data.synthetic import make_synthetic_stamp, star_source
from celeste_tpu.kernels import tiled_field as jtf
from celeste_tpu.model.galaxy import block_support_radii as j_radii
from celeste_tpu.parallel import CrowdedScene as JScene
from celeste_tpu.parallel import tiles as jtiles

from celeste_tpu_torch.bench.config5 import build_config5
from celeste_tpu_torch.kernels import tiled_field as ttf
from celeste_tpu_torch.kernels.tiled_field import random_tile_problem
from celeste_tpu_torch.model.galaxy import block_support_radii
from celeste_tpu_torch.parallel import CrowdedScene
from celeste_tpu_torch.parallel import tiles as ttiles

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse fixture)
    one_torch_thread,
    port_stamp,
)

TOL = dict(rtol=2e-6, atol=1.0)
GRAD_TOL = dict(rtol=5e-4, atol=0.1)
PLANE_TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("amp", "mx", "my", "pa", "pb", "pc")


@pytest.fixture(scope="module")
def star_field():
    """12 stars scattered over a 64x256 field (tests/test_tiled_field.py)."""
    rng = np.random.default_rng(5)
    cosd = np.cos(np.deg2rad(10.0))
    srcs = []
    for i in range(12):
        px, py = rng.uniform(10, 246), rng.uniform(6, 58)
        de, dn = (px - 127.5) * 0.396, (py - 31.5) * 0.396
        srcs.append(star_source(u=(30.0 + de / 3600 / cosd, 10.0 + dn / 3600),
                                flux_r=15 + 5 * (i % 4)))
    scene = make_synthetic_stamp(srcs, shape=(64, 256), bands=(2,), seed=55)
    jstamp = scene.stamps[0]
    pos = np.stack([np.asarray(jstamp.duas2pixel(jnp.asarray(scene.wcs.equa2duas(s["u"]),
                                                             jnp.float32))) for s in srcs])
    vec = np.concatenate([np.concatenate([scene.wcs.equa2duas(s["u"]), np.log(s["flux"])])
                          for s in srcs])
    vecs = (vec[None] + 0.01 * np.random.default_rng(1).normal(size=(6, vec.size)))
    return {"jstamp": jstamp, "tstamp": port_stamp(jstamp), "pos": pos,
            "vecs": vecs.astype(np.float32), "kinds": ("star",) * 12, "n_bands": 5, "band": 2,
            "j_tm": jtiles.build_tile_map(pos, 10.0, (64, 256)),
            "t_tm": ttiles.build_tile_map(pos, 10.0, (64, 256)), "n_comp": 3}


@pytest.fixture(scope="module")
def config5():
    """BASELINE config 5 built by both packages (positions, radii, counts)."""
    _, _, jvec, jinfo = j_build_config5()
    _, _, tvec, tinfo = build_config5(device="cpu")
    vecs = (np.asarray(jvec)[None] + 0.01 * np.random.default_rng(3).normal(size=(5, 44)))
    return {"jinfo": jinfo, "tinfo": tinfo, "jvec": np.asarray(jvec), "tvec": tvec.numpy(),
            "vecs": vecs.astype(np.float32), "n_comp": 3}


def _eq(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_tile_maps_match_jax(star_field, config5):
    j, t = star_field["j_tm"], star_field["t_tm"]
    for f in ("h", "w", "h_pad", "w_pad", "n_ty", "n_tx", "s_max", "n_sources", "n_dropped"):
        assert getattr(j, f) == getattr(t, f), f
    _eq(j.tile_src, t.tile_src)
    # truncation keeps the closest sources, identically
    pos = np.stack([np.full(5, 10.0), np.arange(5, dtype=float) + 1], axis=1)
    jt = jtiles.build_tile_map(pos, 2.0, (8, 128), s_max=3)
    tt = ttiles.build_tile_map(pos, 2.0, (8, 128), s_max=3)
    assert tt.n_dropped == jt.n_dropped > 0
    _eq(jt.tile_src, tt.tile_src)
    # config 5: per-block radii and the component-block map
    kinds = config5["tinfo"]["scene"].kinds
    _eq(config5["jinfo"]["positions_px"], config5["tinfo"]["positions_px"])
    _eq(j_radii(kinds, 1.4, 3.0), block_support_radii(kinds, 1.4, 3.0))
    _eq(config5["jinfo"]["tiled_data"].tile_map.tile_src,
        config5["tinfo"]["tiled_data"].tile_map.tile_src)
    jb = jtiles.build_block_tile_map(config5["jinfo"]["positions_px"], 14.0, kinds, (48, 128), 16)
    tb = ttiles.build_block_tile_map(config5["tinfo"]["positions_px"], 14.0, kinds, (48, 128), 16)
    _eq(jb.tile_src, tb.tile_src)
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(20, 200))
    tm = ttiles.build_tile_map(np.zeros((1, 2)), 1.0, shape=(20, 200))
    _eq(jtiles.tile_field_arrays(tm, arr, pad_values=(0.0,))[0],
        ttiles.tile_field_arrays(tm, arr, pad_values=(0.0,))[0])
    for a, b in zip(jtiles.tile_pixel_coords(tm), ttiles.tile_pixel_coords(tm)):
        _eq(a, b)


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_tiled_stamp_data_matches_jax(star_field, config5, n_buckets):
    jd = jtf.TiledStampData(star_field["j_tm"], star_field["jstamp"], n_buckets=n_buckets)
    td = ttf.TiledStampData(star_field["t_tm"], star_field["tstamp"], n_buckets=n_buckets)
    for pair in ((jd, td), (config5["jinfo"]["tiled_data"], config5["tinfo"]["tiled_data"])):
        j, t = pair
        _eq(j.tile_src, t.tile_src)
        for a, b in zip(j.pixels, t.pixels):
            _eq(a, b)
        assert [int(c) for _, c in j.buckets] == [c for _, c in t.buckets]
        for (js, _), (ts, _), tab in zip(j.buckets, t.buckets, t.bucket_tables):
            _eq(js, ts)
            _eq(np.asarray(j.tile_src)[np.asarray(js)][:, :tab.s_cap], tab.tile_src)
    assert len(config5["tinfo"]["tiled_data"].buckets) == 2


def test_scene_planes_match_jax(star_field, config5):
    sf = star_field
    got = ttf.scene_planes_padded(CrowdedScene(kinds=sf["kinds"], n_bands=5),
                                  torch.as_tensor(sf["vecs"]), sf["tstamp"], band=2)
    want = jax.jit(lambda v: jtf.scene_planes_padded(JScene(kinds=sf["kinds"], n_bands=5), v,
                                                     sf["jstamp"], band=2))(jnp.asarray(sf["vecs"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6, 13 * 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PLANE_TOL)
    j, t = config5["jinfo"], config5["tinfo"]
    got = ttf.scene_planes_blocked(t["scene"], torch.as_tensor(config5["vecs"]), t["stamp"], 0)
    want = jax.jit(lambda v: jtf.scene_planes_blocked(j["scene"], v, j["stamp"], 0))(
        jnp.asarray(config5["vecs"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (5, (12 * 16 + 1) * 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PLANE_TOL)
        assert np.all(g.numpy()[:, -3:] == 0.0)


def _field_problem(name, star_field, config5):
    """(JAX and port planes functions, tile data, vectors, n_comp) of one field."""
    if name == "stars":
        sf = star_field
        jd = jtf.TiledStampData(sf["j_tm"], sf["jstamp"])
        td = ttf.TiledStampData(sf["t_tm"], sf["tstamp"])
        js, ts = JScene(kinds=sf["kinds"], n_bands=5), CrowdedScene(kinds=sf["kinds"], n_bands=5)
        return (lambda v: jtf.scene_planes_padded(js, v, sf["jstamp"], 2),
                lambda v: ttf.scene_planes_padded(ts, v, sf["tstamp"], 2), jd, td, sf["vecs"])
    j, t = config5["jinfo"], config5["tinfo"]
    return (lambda v: jtf.scene_planes_blocked(j["scene"], v, j["stamp"], 0),
            lambda v: ttf.scene_planes_blocked(t["scene"], v, t["stamp"], 0),
            j["tiled_data"], t["tiled_data"], config5["vecs"])


@pytest.mark.parametrize("field", ["stars", "config5"])
def test_plain_loglik_and_gradient_match_jax(star_field, config5, field):
    jplanes, tplanes, jd, td, vecs = _field_problem(field, star_field, config5)

    def j_sum(v, centered):
        ll = jtf.tiled_field_loglik(jplanes(v), jd, n_comp=3, impl="jnp", centered=centered)
        return jnp.sum(ll), ll

    j_value_and_grad = jax.jit(jax.value_and_grad(j_sum, has_aux=True), static_argnums=1)
    for centered in (False, True):
        (_, want), want_g = j_value_and_grad(jnp.asarray(vecs), centered)
        x = torch.as_tensor(vecs).requires_grad_(True)
        got = ttf.tiled_field_loglik(tplanes(x), td, n_comp=3, centered=centered)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        (g,) = torch.autograd.grad(got.sum(), x)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)
        assert np.all(np.isfinite(g.numpy()))
        # values without autograd take the plain K2 path
        with torch.no_grad():
            again = ttf.tiled_field_loglik(tplanes(torch.as_tensor(vecs)), td, n_comp=3,
                                           centered=centered)
        np.testing.assert_allclose(again.numpy(), got.detach().numpy(), rtol=1e-6, atol=1e-2)


def test_plain_loglik_matches_jax_pallas_interpret(star_field):
    """The JAX Pallas forward in interpret mode, as its own tests run it."""
    jplanes, tplanes, jd, td, vecs = _field_problem("stars", star_field, None)
    want = jtf.tiled_field_loglik(jplanes(jnp.asarray(vecs)), jd, n_comp=3, interpret=True)
    got = ttf.tiled_field_loglik(tplanes(torch.as_tensor(vecs)), td, n_comp=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_k3_k4_match_jax_pallas_interpret():
    planes, tile_src, pixels, g = random_tile_problem()
    c, s = 3, tile_src.shape[1]
    jp = tuple(jnp.asarray(x) for x in planes)
    jpix = tuple(jnp.asarray(x) for x in pixels)
    ll_j, lam_j = jtf._tiled_pallas_fwd_lam(list(jp), jnp.asarray(tile_src), jpix, c, s, 128,
                                            True)
    d_j = jtf._tiled_bwd_pallas(jp, jnp.asarray(tile_src), jpix, lam_j, jnp.asarray(g), c, s,
                                128, True)
    tp = tuple(torch.as_tensor(x) for x in planes)
    tpix = tuple(torch.as_tensor(x) for x in pixels)
    ts = torch.as_tensor(tile_src)
    ll_t, lam_t = ttf._tiled_lam_torch(tp, ts, tpix, c)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=2e-5, atol=2e-2)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j)[:, :6], rtol=1e-5, atol=1e-4)
    d_t = ttf._tiled_bwd_torch(tp, ts, tpix, lam_t, torch.as_tensor(g), c)
    for name, a, r in zip(NAMES, d_t, d_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4, atol=5e-3, err_msg=name)
    # and the hand backward against torch autograd of the plain forward
    leaves = [p.clone().requires_grad_(True) for p in tp]
    auto = torch.autograd.grad(ttf._tiled_torch(leaves, ts, tpix, c), leaves,
                               torch.as_tensor(g))
    for name, a, r in zip(NAMES, d_t, auto):
        torch.testing.assert_close(a, r, rtol=2e-4, atol=5e-3, msg=name)
    assert all(bool(torch.isfinite(d).all()) for d in d_t)


LOG2E = 1.4426950408889634


def _moment_cotangents(planes, tile_src, px, py, n_comp, g_lam):
    """The backward of ``csrc/tiled_field.cu`` (K4, K6) in moment form, in
    torch: per (tile, entry) the six pixel moments of ge = g_lam e, with e
    from the base-2 form the kernels stage, turned into the six cotangents
    by the kernels' epilogue, then summed into the plane columns in the
    order of ``tile_columns``."""
    t_n, s_cap = tile_src.shape
    plane_w = planes[0].shape[1]
    cols = (tile_src.long()[:, :, None] * n_comp + torch.arange(n_comp)).reshape(t_n, -1)
    parts = []
    for t in range(t_n):
        amp, mx, my, pa, pb, pc = (p[:, cols[t], None] for p in planes)   # [B, K, 1]
        dx, dy = px[t] - mx, py[t] - my                                    # [B, K, PIX]
        dxx, dxy, dyy = dx * dx, dx * dy, dy * dy
        e = torch.exp2((-0.5 * LOG2E * pa) * dxx + (-LOG2E * pb) * dxy + (-0.5 * LOG2E * pc) * dyy)
        ge = g_lam[t][:, None, :] * e
        s0, sx, sy, sxx, sxy, syy = (torch.sum(ge * m, -1) for m in (1.0, dx, dy, dxx, dxy, dyy))
        a, pa, pb, pc = amp[..., 0], pa[..., 0], pb[..., 0], pc[..., 0]
        parts.append(torch.stack([s0, a * (pa * sx + pb * sy), a * (pb * sx + pc * sy),
                                  -0.5 * a * sxx, -a * sxy, -0.5 * a * syy]))   # [6, B, K]
    d_part = torch.cat(parts, dim=2)                                       # [6, B, T*K]
    col_ptr, col_ent = ttf.tile_columns(tile_src.numpy(), n_comp, plane_w)
    out = torch.zeros(6, planes[0].shape[0], plane_w, dtype=d_part.dtype)
    for c in range(plane_w):
        for e in col_ent[col_ptr[c]:col_ptr[c + 1]]:
            out[:, :, c] += d_part[:, :, e]
    return tuple(out)


@pytest.mark.parametrize("seed", [3, 5, 8])
@pytest.mark.parametrize("c", [1, 3])
def test_moment_form_backward_matches_plain_k4(seed, c):
    """K4's algebra (moments, epilogue, column scatter) against the plain
    K4 at the card's random-plane gate, rtol 2e-4, atol 5e-3."""
    planes, tile_src, pixels, g = random_tile_problem(seed=seed, b=7, s=5, c=c, t=3)
    tp = tuple(torch.as_tensor(x) for x in planes)
    px, py, counts, _, mask = tpix = tuple(torch.as_tensor(x) for x in pixels)
    ts, gt = torch.as_tensor(tile_src), torch.as_tensor(g)
    _, lam = ttf._tiled_lam_torch(tp, ts, tpix, c)
    active = (lam > ttf.LAMBDA_MIN).to(lam.dtype)
    g_lam = ((gt[None, :, None] * mask[:, None, :])
             * (counts[:, None, :] / torch.clamp(lam, min=ttf.LAMBDA_MIN) - 1.0) * active)
    got = _moment_cotangents(tp, ts, px, py, c, g_lam)
    for name, a, w in zip(NAMES, got, ttf._tiled_bwd_torch(tp, ts, tpix, lam, gt, c)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=5e-3, msg=name)


@pytest.mark.parametrize("seed", [3, 5, 8])
@pytest.mark.parametrize("c", [1, 3])
def test_moment_form_backward_matches_plain_k6(seed, c):
    """K6's algebra, a given cotangent of the sky-free lambda, against the
    plain K6 at the same gate."""
    planes, tile_src, pixels, _ = random_tile_problem(seed=seed, b=5, s=4, c=c, t=2)
    tp = tuple(torch.as_tensor(x) for x in planes)
    px, py = (torch.as_tensor(x) for x in pixels[:2])
    ts = torch.as_tensor(tile_src)
    g = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(2, 5, 1024)),
                        dtype=torch.float32)
    got = _moment_cotangents(tp, ts, px, py, c, g)
    for name, a, w in zip(NAMES, got, ttf._tiled_render_bwd_torch(tp, ts, px, py, g, c)):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=5e-3, msg=name)


def test_chunked_and_unchunked_plain_versions_agree(monkeypatch):
    planes, tile_src, pixels, g = random_tile_problem(seed=7, b=7)
    tp = tuple(torch.as_tensor(x) for x in planes)
    tpix = tuple(torch.as_tensor(x) for x in pixels)
    ts, gt = torch.as_tensor(tile_src), torch.as_tensor(g)
    whole_ll, whole_lam = ttf._tiled_lam_torch(tp, ts, tpix, 3)
    whole_fwd = ttf._tiled_torch(tp, ts, tpix, 3)
    whole = ttf._tiled_bwd_torch(tp, ts, tpix, whole_lam, gt, 3)
    assert ttf._chain_chunk(7, 4, 3) == 7
    monkeypatch.setattr(ttf, "_chain_chunk", lambda b, *a: 2)
    ll, lam = ttf._tiled_lam_torch(tp, ts, tpix, 3)
    torch.testing.assert_close(lam, whole_lam, rtol=0, atol=0)
    torch.testing.assert_close(ll, whole_ll, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(ttf._tiled_torch(tp, ts, tpix, 3), whole_fwd, rtol=1e-6,
                               atol=1e-3)
    for a, w in zip(ttf._tiled_bwd_torch(tp, ts, tpix, lam, gt, 3), whole):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-5)


def test_tile_columns_list_every_entry_once():
    _, tile_src, _, _ = random_tile_problem()
    col_ptr, col_ent = ttf.tile_columns(tile_src, 3, 15)
    assert col_ptr.dtype == col_ent.dtype == np.int32
    assert col_ptr[0] == 0 and col_ptr[-1] == tile_src.size * 3
    assert sorted(col_ent.tolist()) == list(range(tile_src.size * 3))
    cols = (tile_src[:, :, None] * 3 + np.arange(3)).reshape(-1)
    for col in range(15):
        ent = col_ent[col_ptr[col]:col_ptr[col + 1]]
        assert np.all(cols[ent] == col) and np.all(np.diff(ent) > 0)
        assert len(ent) == np.sum(cols == col)
    with pytest.raises(ValueError):
        ttf.tile_columns(tile_src, 3, 12)


def test_zero_sentinel_adds_nothing_and_has_finite_gradients():
    planes, tile_src, pixels, g = random_tile_problem(seed=11)
    tp = tuple(torch.as_tensor(x) for x in planes)
    tpix = tuple(torch.as_tensor(x) for x in pixels)
    only_sentinel = torch.full((3, 4), 4, dtype=torch.int32)
    ll, lam = ttf._tiled_lam_torch(tp, only_sentinel, tpix, 3)
    torch.testing.assert_close(lam, tpix[3][:, None, :].expand_as(lam), rtol=0, atol=0)
    grads = ttf._tiled_bwd_torch(tp, only_sentinel, tpix, lam, torch.as_tensor(g), 3)
    assert all(bool(torch.isfinite(d).all()) for d in grads)
    assert all(bool((d[:, :12] == 0).all()) for d in grads)


def test_cpu_tensors_take_the_plain_version_and_wrappers_refuse_them(config5):
    td = config5["tinfo"]["tiled_data"]
    planes = ttf.scene_planes_blocked(config5["tinfo"]["scene"], torch.as_tensor(config5["vecs"]),
                                      config5["tinfo"]["stamp"], 0)
    planes = [p.contiguous() for p in planes]
    before = ttf.launch_counts()
    with torch.no_grad():
        ttf.tiled_field_loglik(planes, td, n_comp=3)
    assert ttf.launch_counts() == before
    bk = td.bucket_tables[0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttf.tiled_fwd_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)
    lam = torch.zeros(bk.tile_src.shape[0], 5, 1024)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttf.tiled_bwd_cuda(*planes, bk.tile_src, *bk.pixels, lam, torch.ones(5),
                           *bk.columns(3, planes[0].shape[1]), n_comp=3)
    meta = [torch.empty(p.shape, device="meta") for p in planes]
    with pytest.raises(ValueError, match="no implementation"):
        ttf.tiled_field_loglik(meta, td, n_comp=3)
