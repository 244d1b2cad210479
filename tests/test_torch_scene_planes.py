"""Plane preparation of the tiled crowded field
(``celeste_tpu_torch/kernels/scene_planes.py``, ``csrc/scene_planes.cu``).

On the CPU: the wrapper's CPU branch is the plain per-band functions
(``scene_planes_blocked`` / ``scene_planes_padded``) bit for bit, values and
gradients; and the kernels' algebra, written out in torch over the constants
``pack_constants`` uploads (the forward formula for formula, the backward's
hand chain rule), matches the plain planes and their autograd gradient.

On the card (the ``cuda`` marker; skipped where CUDA is absent, decided in
the ``cuda`` fixture): the kernel pair against the plain version on config
5's scene in one band (mixed, block-slot layout) and in three, on a scene of
stars and one of galaxies (source-major layout) and on a scene with an
anisotropic PSF and a rotated WCS, at chain counts that are not a multiple
of a block; exact zeros in the unused slots and the sentinel; equal bits
from call to call; one forward and one backward launch per gradient of the
tiled log density; no host synchronisation.  The card tests import torch
and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scene_planes.py -m cuda

Tolerances.  Planes on the card: equal bits.  The kernel rounds every
product and sum on its own (built with -fmad=false) in the plain version's
order, with the same accurate expf, logf and sincosf as PyTorch's CUDA
operations, so it gives the plain version's float32 values exactly.  On the
CPU, the torch rehearsal against the plain planes: rtol 2e-6, atol 1e-6
(~16 ulp of float32: the same formulas, evaluated by other vectorised
kernels).  Gradients: per state column, the distance from the plain
version's gradient evaluated in float64 is at most 4 times that of the
float32 plain version, plus 1e-4 of the column's largest magnitude.  Each
entry sums up to 48 components per band (144 in three bands) in another
order than autograd; on config 5's round PSF the phi column is a difference
of terms ~1e3 times its own size, so both float32 paths miss it by ~1e-4 of
its scale, and the kernel no more than the plain version (at most 1.7 times
its error in any column at config 5's shapes, on the H100).  An error in
the algebra moves a column by O(1) of its scale.
"""

import numpy as np
import pytest
import torch

from celeste_tpu_torch.kernels import scene_planes as sp
from celeste_tpu_torch.kernels.tiled_field import scene_planes_blocked, scene_planes_padded
from celeste_tpu_torch.model.stamp import Stamp
from celeste_tpu_torch.mog import MoG2D
from celeste_tpu_torch.parallel.crowded import CrowdedScene

PLANE_TOL = dict(rtol=2e-6, atol=1e-6)
GRAD_PLAIN, GRAD_ATOL = 4.0, 1e-4
N_EXP, N_GAL = 6, 16


# ---------------------------------------------------------------------------
# scenes, with no JAX: config 5's (bench/config5.py) and random ones
# ---------------------------------------------------------------------------

def _random_stamps(n_bands, k, device, seed):
    """Stamps whose PSFs are anisotropic and off-centre and whose WCS is
    rotated and sheared, so that every term of the algebra is non-zero."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float32, device=device)
    stamps = []
    for _ in range(n_bands):
        w = rng.uniform(0.1, 1.0, k)
        mu = rng.normal(0.0, 0.3, (k, 2))
        cov = []
        for _ in range(k):
            l = np.array([[rng.uniform(0.8, 3.0), 0.0], [rng.normal(0.0, 0.6),
                                                         rng.uniform(0.8, 3.0)]])
            cov.append(l @ l.T)
        rot = rng.uniform(0, np.pi)
        a = 2.5 * np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
        a = a @ np.array([[1.0, 0.1], [0.0, 0.9]])
        psf = MoG2D(torch.as_tensor(w / w.sum(), **kw), torch.as_tensor(mu, **kw),
                    torch.as_tensor(np.asarray(cov), **kw))
        stamps.append(Stamp(counts=torch.zeros(48, 128, **kw),
                            sky=torch.full((48, 128), 150.0, **kw),
                            iota=torch.tensor(rng.uniform(500, 900), **kw),
                            mask=torch.ones(48, 128, **kw), psf=psf,
                            wcs_A=torch.as_tensor(a, **kw),
                            wcs_p0=torch.as_tensor(rng.uniform(20, 60, 2), **kw), band=0))
    return stamps


def _random_states(scene, b, seed, device):
    """[b, D] states: positions near 0, log-fluxes near 3, galaxy shapes
    spread over their range."""
    rng = np.random.default_rng(seed)
    blocks, d = scene.block_slices()
    x = np.zeros((b, d))
    nb = scene.n_bands
    for off, _, kind in blocks:
        x[:, off:off + 2] = rng.normal(0.0, 3.0, (b, 2))
        x[:, off + 2:off + 2 + nb] = rng.normal(3.0, 0.3, (b, nb))
        if kind == "galaxy":
            x[:, off + 2 + nb] = rng.normal(0.0, 1.5, b)
            x[:, off + 3 + nb] = rng.normal(0.0, 0.4, b)
            x[:, off + 4 + nb] = rng.normal(0.0, 1.0, b)
            x[:, off + 5 + nb] = rng.uniform(-3.0, 3.0, b)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


RANDOM_SCENES = {
    "mixed, 1 band": (("star", "galaxy", "star", "star", "galaxy"), 1, [0]),
    "mixed, 3 bands of 5": (("galaxy", "star", "star", "galaxy"), 5, [1, 2, 3]),
    "stars, 2 bands": (("star",) * 4, 2, [1, 0]),
    "galaxies, 1 band of 2": (("galaxy",) * 3, 2, [1]),
}


def _random_problem(name, b, device, seed=0):
    kinds, n_bands, bands = RANDOM_SCENES[name]
    scene = CrowdedScene(kinds=kinds, n_bands=n_bands)
    stamps = _random_stamps(len(bands), 3, device, seed)
    return scene, stamps, bands, _random_states(scene, b, seed + 1, device)


def _plain(scene, stamps, bands, vecs):
    fn = scene_planes_blocked if len(set(scene.kinds)) > 1 else scene_planes_padded
    return [fn(scene, vecs, st, b) for st, b in zip(stamps, bands)]


def _vjp(planes_of, vecs, cots):
    """The states' gradient of sum(planes * cotangents), by autograd."""
    x = vecs.detach().clone().requires_grad_(True)
    planes = [p for band in planes_of(x) for p in band]
    total = sum(torch.sum(p * g) for p, g in zip(planes, cots))
    return torch.autograd.grad(total, x)[0]


def _plain_vjp(prep):
    def vjp(vecs, cots):
        return _vjp(lambda x: _plain(prep.scene, prep.stamps, prep.bands, x), vecs, cots)

    return vjp


def _cotangents(planes, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(p.shape, generator=gen).to(p.device) for band in planes for p in band]


def _assert_grad_close(got, plain_vjp, vecs, cots):
    """``got`` against the plain gradient: per state column, its distance
    from the float64 evaluation at most GRAD_PLAIN times the float32 plain
    version's plus GRAD_ATOL of the column's scale."""
    want = plain_vjp(vecs, cots)
    ref = plain_vjp(vecs.double(), [c.double() for c in cots])
    scale = ref.abs().amax(dim=0)
    err = (got.double() - ref).abs().amax(dim=0)
    bound = GRAD_PLAIN * (want.double() - ref).abs().amax(dim=0) + GRAD_ATOL * scale
    worst = int(torch.argmax(err - bound))
    assert bool((err <= bound).all()), (
        f"column {worst}: off by {float(err[worst]):.3e}, bound {float(bound[worst]):.3e}, "
        f"scale {float(scale[worst]):.3e}")


# ---------------------------------------------------------------------------
# the kernels' algebra, written out in torch over the packed constants
# ---------------------------------------------------------------------------

def _kernel_algebra(prep, vecs, cots):
    """csrc/scene_planes.cu written out in torch: (planes per band, the
    gradient from the cotangents ``cots``), read from ``pack_constants``'
    arrays as the kernels read them."""
    consts, table = sp.pack_constants(prep.scene, prep.stamps, prep.bands)
    consts = torch.as_tensor(consts)
    k, n_src, nb, n_pb = prep.n_comp, prep.scene.n_sources, prep.scene.n_bands, len(prep.bands)
    stride = 7 + 7 * k
    prof = consts[n_pb * stride:]
    b = vecs.shape[0]
    planes = [[vecs.new_zeros(b, prep.plane_w) for _ in range(6)] for _ in range(n_pb)]
    grad = torch.zeros_like(vecs)
    for s in range(n_src):
        galaxy, off = bool(table[2 * s]), int(table[2 * s + 1])
        v = vecs[:, off:]
        g_u0 = g_u1 = g_wxx = g_wxy = g_wyy = g_th = 0.0
        for q in range(n_pb):
            bc = consts[q * stride:(q + 1) * stride]
            band = int(table[2 * n_src + q])
            a, bb, c, d = bc[0], bc[1], bc[2], bc[3]
            px = bc[4] + (a * v[:, 0] + bb * v[:, 1])
            py = bc[5] + (c * v[:, 0] + d * v[:, 1])
            amp0 = bc[6] * torch.exp(v[:, 2 + band])
            if galaxy:
                theta = torch.sigmoid(v[:, 2 + nb])
                sigma = torch.exp(v[:, 3 + nb])
                ab = torch.sigmoid(v[:, 4 + nb])
                cs, sn = torch.cos(v[:, 5 + nb]), torch.sin(v[:, 5 + nb])
                maj, mnr = sigma * sigma, (ab * sigma) * (ab * sigma)
                wxx = cs * cs * maj + sn * sn * mnr
                wyy = sn * sn * maj + cs * cs * mnr
                wxy = cs * sn * (maj - mnr)
                r0x, r0y = a * wxx + bb * wxy, a * wxy + bb * wyy
                r1x, r1y = c * wxx + d * wxy, c * wxy + d * wyy
                oxx, oxy, oyy = r0x * a + r0y * bb, r0x * c + r0y * d, r1x * c + r1y * d
            gpx = gpy = gxx = gxy = gyy = glf = 0.0
            for j in range(N_GAL if galaxy else 1):
                for kk in range(k):
                    psf = bc[7 + 7 * kk:14 + 7 * kk]
                    if galaxy:
                        pw = (1.0 - theta) * prof[j] if j < N_EXP else theta * prof[j]
                        var = prof[N_GAL + j]
                        w = pw * psf[0]
                        s00, s01 = var * oxx + psf[3], var * oxy + psf[4]
                        s10, s11 = var * oxy + psf[5], var * oyy + psf[6]
                    else:
                        w = psf[0]
                        s00, s01, s10, s11 = psf[3], psf[4], psf[5], psf[6]
                    mx, my = psf[1] + px, psf[2] + py
                    det = s00 * s11 - s01 * s10
                    inv = 1.0 / det
                    pa, pb, pc = s11 * inv, -s01 * inv, s00 * inv
                    e = torch.exp(-1.8378770664093453 - 0.5 * torch.log(det))
                    amp = amp0 * w * e
                    col = s * prep.src_w + j * k + kk
                    vals = (amp, mx, my, pa, pb, pc)
                    gp = [cots[6 * q + i][:, col] for i in range(6)]
                    for i in range(6):
                        planes[q][i][:, col] = vals[i]
                    t = gp[0] * amp
                    glf, gpx, gpy = glf + t, gpx + gp[1], gpy + gp[2]
                    if galaxy:
                        dw = amp0 * psf[0] * e
                        g_th = g_th + gp[0] * dw * (-prof[j] if j < N_EXP else prof[j])
                        gdet = -inv * (gp[3] * pa + gp[4] * pb + gp[5] * pc) - 0.5 * inv * t
                        gxx = gxx + var * (gp[5] * inv + gdet * s11)
                        gxy = gxy + var * ((-gp[4] * inv - gdet * s10) - gdet * s01)
                        gyy = gyy + var * (gp[3] * inv + gdet * s00)
            g_u0 = g_u0 + a * gpx + c * gpy
            g_u1 = g_u1 + bb * gpx + d * gpy
            g_wxx = g_wxx + a * a * gxx + a * c * gxy + c * c * gyy
            g_wxy = g_wxy + 2.0 * a * bb * gxx + (bb * c + a * d) * gxy + 2.0 * c * d * gyy
            g_wyy = g_wyy + bb * bb * gxx + bb * d * gxy + d * d * gyy
            grad[:, off + 2 + band] += glf
        grad[:, off] += g_u0
        grad[:, off + 1] += g_u1
        if galaxy:
            g_maj = cs * cs * g_wxx + sn * sn * g_wyy + cs * sn * g_wxy
            g_mnr = sn * sn * g_wxx + cs * cs * g_wyy - cs * sn * g_wxy
            g_cs = 2 * cs * maj * g_wxx + 2 * cs * mnr * g_wyy + sn * (maj - mnr) * g_wxy
            g_sn = 2 * sn * mnr * g_wxx + 2 * sn * maj * g_wyy + cs * (maj - mnr) * g_wxy
            grad[:, off + 2 + nb] = g_th * theta * (1 - theta)
            grad[:, off + 3 + nb] = (2 * sigma * g_maj + 2 * (ab * sigma) * ab * g_mnr) * sigma
            grad[:, off + 4 + nb] = 2 * (ab * sigma) * sigma * g_mnr * ab * (1 - ab)
            grad[:, off + 5 + nb] = -sn * g_cs + cs * g_sn
    return planes, grad


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RANDOM_SCENES))
def test_cpu_branch_is_the_plain_functions_bit_for_bit(name):
    scene, stamps, bands, vecs = _random_problem(name, 5, "cpu")
    prep = sp.ScenePlanes(scene, stamps, bands)
    got, want = prep(vecs), _plain(scene, stamps, bands, vecs)
    assert len(got) == len(bands)
    for gb, wb in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(gb, wb))
    cots = _cotangents(want, 3)
    assert torch.equal(_vjp(prep, vecs, cots),
                       _vjp(lambda x: _plain(scene, stamps, bands, x), vecs, cots))
    assert prep.consts is None and sp.launch_counts()["scene_planes_fwd"] == 0


@pytest.mark.parametrize("name", sorted(RANDOM_SCENES))
def test_kernel_algebra_matches_plain_planes_and_autograd(name):
    scene, stamps, bands, vecs = _random_problem(name, 6, "cpu", seed=7)
    prep = sp.ScenePlanes(scene, stamps, bands)
    want = _plain(scene, stamps, bands, vecs)
    cots = _cotangents(want, 11)
    planes, grad = _kernel_algebra(prep, vecs, cots)
    for gb, wb in zip(planes, want):
        for g, w in zip(gb, wb):
            torch.testing.assert_close(g, w.contiguous(), **PLANE_TOL)
    _assert_grad_close(grad, _plain_vjp(prep), vecs, cots)


def test_layout_follows_the_kinds():
    for name, width, sentinel in (("mixed, 1 band", N_GAL * 3, 3), ("stars, 2 bands", 3, 3),
                                  ("galaxies, 1 band of 2", N_GAL * 3, N_GAL * 3)):
        scene, stamps, bands, _ = _random_problem(name, 1, "cpu")
        prep = sp.ScenePlanes(scene, stamps, bands)
        assert (prep.src_w, prep.plane_w) == (width, scene.n_sources * width + sentinel)
    consts, table = sp.pack_constants(scene, stamps, bands)
    assert consts.dtype == np.float32 and consts.size == len(bands) * (7 + 7 * 3) + 2 * N_GAL
    assert table.tolist() == [1, 0, 1, 8, 1, 16, 1]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def c5(cuda):
    """Config 5's log density and scene in r and in g, r, i, and a scene of
    its stars and one of its galaxies on its r stamp."""
    from celeste_tpu_torch.bench.config5 import build_config5, build_config5_multiband

    logd, _, vec, info = build_config5(device=cuda)
    logd3, _, vec3, info3 = build_config5_multiband(device=cuda)
    blocks, _ = info["scene"].block_slices()
    out = {"c5_r": (info["scene"], [info["stamp"]], [0], vec, logd),
           "c5_gri": (info3["scene"], info3["stamps"], [0, 1, 2], vec3, logd3)}
    for name, kind in (("c5 stars", "star"), ("c5 galaxies", "galaxy")):
        mine = [(off, d) for off, d, k in blocks if k == kind]
        scene = CrowdedScene(kinds=(kind,) * len(mine), n_bands=1)
        out[name] = (scene, [info["stamp"]], [0],
                     torch.cat([vec[off:off + d] for off, d in mine]), None)
    return out


CARD_SCENES = ["c5_r", "c5_gri", "c5 stars", "c5 galaxies"] + sorted(RANDOM_SCENES)


def _card_problem(c5, cuda, name, b, seed=0):
    """(ScenePlanes, states [b, D]) on the card: config 5's scenes at their
    truth plus noise of 0.01, the random scenes as drawn above."""
    if name in RANDOM_SCENES:
        scene, stamps, bands, vecs = _random_problem(name, b, cuda, seed)
    else:
        scene, stamps, bands, vec, _ = c5[name]
        noise = np.random.default_rng(seed).normal(0.0, 0.01, (b, vec.shape[0]))
        vecs = vec[None] + torch.as_tensor(noise, dtype=torch.float32, device=cuda)
    return sp.ScenePlanes(scene, stamps, bands), vecs


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_SCENES)
def test_kernel_planes_match_plain(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 1001)
    got = prep(vecs)
    want = _plain(prep.scene, prep.stamps, prep.bands, vecs)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.is_contiguous() and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_SCENES)
def test_kernel_vjp_matches_plain_autograd(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 777, seed=2)
    cots = _cotangents(prep(vecs), 5)
    _assert_grad_close(_vjp(prep, vecs, cots), _plain_vjp(prep), vecs, cots)


def _live_columns(prep):
    """Bool [W]: the columns a source fills (a star's first K of its slot)."""
    live = np.zeros(prep.plane_w, bool)
    for s, kind in enumerate(prep.scene.kinds):
        width = prep.src_w if kind == "galaxy" else prep.n_comp
        live[s * prep.src_w:s * prep.src_w + width] = True
    return torch.as_tensor(live)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_gri", "c5 stars", "c5 galaxies", "mixed, 3 bands of 5"])
def test_unused_slots_and_sentinel_are_exactly_zero(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 300)
    dead = ~_live_columns(prep).to(cuda)
    assert bool(dead[-prep.n_comp:].all())
    for band in prep(vecs):
        for p in band:
            assert bool((p[:, dead] == 0).all())
            assert bool(torch.isfinite(p).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri", "mixed, 3 bands of 5"])
def test_two_calls_give_equal_bits(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 4099, seed=3)
    cots = [c.contiguous() for c in _cotangents(prep(vecs), 9)]
    fwd = [sp.scene_planes_fwd_cuda(prep, vecs) for _ in range(2)]
    bwd = [sp.scene_planes_bwd_cuda(prep, vecs, cots) for _ in range(2)]
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(bwd[0], bwd[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri"])
def test_one_forward_and_one_backward_launch_per_gradient(cuda, c5, name):
    *_, vec, logd = c5[name]
    x = (vec[None] + torch.zeros(513, vec.shape[0], device=cuda)).requires_grad_(True)
    before = sp.launch_counts()
    lp = logd(x)
    mid = sp.launch_counts()
    (g,) = torch.autograd.grad(lp.sum(), x)
    after = sp.launch_counts()
    assert (mid["scene_planes_fwd"] - before["scene_planes_fwd"],
            mid["scene_planes_bwd"] - before["scene_planes_bwd"]) == (1, 0)
    assert (after["scene_planes_fwd"] - mid["scene_planes_fwd"],
            after["scene_planes_bwd"] - mid["scene_planes_bwd"]) == (0, 1)
    assert bool(torch.isfinite(lp).all()) and bool(torch.isfinite(g).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri"])
def test_no_host_sync_in_plane_preparation(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 1024)
    cots = [c.contiguous() for c in _cotangents(prep(vecs), 1)]
    x = vecs.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        planes = [p for band in prep(x) for p in band]
        grads = torch.autograd.grad(planes, x, cots)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(grads[0]).all())


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda, c5):
    prep, vecs = _card_problem(c5, cuda, "c5_r", 16)
    for bad in (vecs.double(), vecs[:, :-1].contiguous(), vecs.cpu()):
        with pytest.raises(ValueError):
            sp.scene_planes_fwd_cuda(prep, bad)
    with pytest.raises(ValueError):
        sp.scene_planes_fwd_cuda(prep, vecs.t().contiguous().t())
    cots = [torch.zeros(16, prep.plane_w, device=cuda)] * 6
    with pytest.raises(ValueError):
        sp.scene_planes_bwd_cuda(prep, vecs, cots[:5])
    with pytest.raises(ValueError):
        sp.scene_planes_bwd_cuda(prep, vecs, cots[:5] + [cots[0][:, :-1]])
    cpu_prep = sp.ScenePlanes(prep.scene, [s.to("cpu") for s in prep.stamps], prep.bands)
    with pytest.raises(ValueError):
        sp.scene_planes_fwd_cuda(cpu_prep, vecs)
