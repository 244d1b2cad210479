"""The crowded field's prior (``celeste_tpu_torch/kernels/scene_prior.py``,
``csrc/scene_prior.cu``).

On the CPU: the wrapper's CPU branch is ``_crowded_logprior`` bit for bit,
value and gradient; the kernels' algebra, written out in torch over the
constants ``pack_constants`` uploads (the forward formula for formula, the
backward's hand chain rule), matches the plain prior and its autograd
gradient, and is non-finite exactly where the plain prior is; the tiled log
density takes the pair for Gaussian colours and keeps the plain prior for a
``ColorGMM`` one.

On the card (the ``cuda`` marker; skipped where CUDA is absent, decided in
the ``cuda`` fixture): the kernel pair against the plain version on config
5's scene in one band and in three, on a scene of stars, one of galaxies
and random scenes, at chain counts that are not a multiple of a block;
non-finite exactly where the plain prior is; equal bits from call to call;
one forward and one backward launch per gradient of the tiled log density;
no host synchronisation.  The card tests import torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scene_prior.py -m cuda

Tolerances.  Values: rtol 2e-6, atol 1e-4, against the plain float32
version (a chain's value sums ~12 sources' terms of order 10 in the plain
version's order; the kernel shares its formulas but not the vectorised
libm of the CPU).  Gradients: per state column, the distance from the
plain version's gradient in float64 at most 4 times that of the float32
plain version, plus 1e-4 of the column's largest magnitude.  An error in
the algebra moves a column by O(1) of its scale.
"""

import math

import numpy as np
import pytest
import torch

from celeste_tpu_torch.bench.config5 import GALAXIES, N_SOURCES
from celeste_tpu_torch.kernels import scene_prior as sp
from celeste_tpu_torch.model.priors import SourcePriors
from celeste_tpu_torch.parallel.crowded import CrowdedScene, _crowded_logprior

VALUE_TOL = dict(rtol=2e-6, atol=1e-4)
GRAD_PLAIN, GRAD_ATOL = 4.0, 1e-4
C5_KINDS = tuple("galaxy" if i in GALAXIES else "star" for i in range(N_SOURCES))

SCENES = {
    "c5, 1 band": (C5_KINDS, 1),
    "c5, 3 bands": (C5_KINDS, 3),
    "stars, 2 bands": (("star",) * 4, 2),
    "galaxies, 5 bands": (("galaxy",) * 3, 5),
}

def _states(scene, b, kind, seed, device="cpu"):
    """[b, D] states of ``kind``: "near" the typical posterior, "far" with
    |du| past the prior's 60-arcsec half-width, "steep" with logits of +-12
    (finite, the sigmoid near saturation), "saturated" with logits and
    log-fluxes whose sigmoid or exp saturates or overflows in float32 on the
    even chains (non-finite priors)."""
    rng = np.random.default_rng(seed)
    blocks, d = scene.block_slices()
    x = np.zeros((b, d))
    nb = scene.n_bands
    for off, _, k in blocks:
        x[:, off:off + 2] = rng.normal(0.0, 80.0 if kind == "far" else 3.0, (b, 2))
        x[:, off + 2:off + 2 + nb] = rng.normal(3.0, 1.0, (b, nb))
        if k == "galaxy":
            x[:, off + 2 + nb] = rng.normal(0.0, 1.5, b)
            x[:, off + 3 + nb] = rng.normal(0.3, 0.5, b)
            x[:, off + 4 + nb] = rng.normal(0.0, 1.0, b)
            x[:, off + 5 + nb] = rng.uniform(-3.0, 3.0, b)
            if kind in ("steep", "saturated"):
                big = 12.0 if kind == "steep" else 120.0
                for j in (2, 4):
                    x[:, off + j + nb] = rng.choice([-big, big, 0.5], b)
    if kind == "saturated":           # the odd chains keep finite logits
        x[1::2] = _states(scene, b, "near", seed + 1)[1::2].double().numpy()
        x[0::2][rng.random((len(x[0::2]), d)) < 0.02] = 100.0
        x[:, 0] = np.where(np.arange(b) % 3 == 0, -100.0, x[:, 0])
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _problem(name, b, kind="near", seed=0, device="cpu"):
    kinds, nb = SCENES[name]
    scene = CrowdedScene(kinds=kinds, n_bands=nb)
    return scene, _states(scene, b, kind, seed, device)


def _plain_grad(scene, priors, vecs, g):
    x = vecs.detach().clone().requires_grad_(True)
    return torch.autograd.grad(_crowded_logprior(scene, priors, x), x, g)[0]


def _assert_grad_close(got, scene, priors, vecs, g):
    """``got`` against the plain gradient: per state column, its distance
    from the float64 evaluation at most GRAD_PLAIN times the float32 plain
    version's plus GRAD_ATOL of the column's scale."""
    want = _plain_grad(scene, priors, vecs, g)
    ref = _plain_grad(scene, priors, vecs.double(), g.double())
    scale = ref.abs().amax(dim=0)
    err = (got.double() - ref).abs().amax(dim=0)
    bound = GRAD_PLAIN * (want.double() - ref).abs().amax(dim=0) + GRAD_ATOL * scale
    worst = int(torch.argmax(err - bound))
    assert bool((err <= bound).all()), (
        f"column {worst}: off by {float(err[worst]):.3e}, bound {float(bound[worst]):.3e}, "
        f"scale {float(scale[worst]):.3e}")


def _cotangent(b, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, generator=gen).to(device)


# ---------------------------------------------------------------------------
# the kernels' algebra, written out in torch over the packed constants
# ---------------------------------------------------------------------------

def _kernel_algebra(scene, priors, vecs, g):
    """csrc/scene_prior.cu written out in torch: (prior + log |det J| [B],
    the gradient of sum(g * that)), read from ``pack_constants``' arrays as
    the kernels read them."""
    consts, table, ref = sp.pack_constants(scene, priors)
    c = [torch.tensor(float(v)) for v in consts]
    (ref_mean, ref_inv, ref_log, hw, inv_r, ta1, tb1, tnorm, s_mean, s_inv, s_log,
     aa1, ab1, anorm, log_pi) = c[:15]
    nb = scene.n_bands
    cm, cs, cls = c[15:15 + nb - 1], c[14 + nb:13 + 2 * nb], c[13 + 2 * nb:]
    k = torch.tensor(0.9189385332046727)

    def normal(z, log_std):
        return -0.5 * z * z - log_std - k

    def sigmoid(x):
        return 1.0 / (1.0 + torch.exp(-x))

    def softplus(x):
        return torch.where(x > 20.0, x, torch.log1p(torch.exp(x)))

    def sig_ljd_grad(x):
        y = -x
        gs = -g * 2.0
        z = torch.exp(y)
        return -g + -torch.where(y > 20.0, gs, gs * z / (z + 1.0))

    def beta_grad(x, a1, b1):
        return (g * a1) / x + -((g * b1) / (-x + 1.0))

    total = torch.zeros(vecs.shape[0])
    grad = torch.zeros_like(vecs)
    for s in range(scene.n_sources):
        galaxy, off = bool(table[2 * s]), int(table[2 * s + 1])
        v = vecs[:, off:]
        f = [torch.exp(v[:, 2 + b]) for b in range(nb)]
        lf = [torch.log(fb) for fb in f]
        flux = normal((lf[ref] - ref_mean) * ref_inv, ref_log)
        if nb > 1:
            colours = 0.0
            for b in range(nb - 1):
                colours = colours + normal((lf[b] - lf[b + 1] - cm[b]) / cs[b], cls[b])
            flux = flux + colours
        sum_lf = ljd = 0.0
        for b in range(nb):
            sum_lf = sum_lf + lf[b]
            ljd = ljd + v[:, 2 + b]
        flux = flux - sum_lf
        pos = 0.0
        g_u = []
        for i in range(2):
            d = torch.abs(v[:, i]) - hw
            t = torch.where(d < 0.0, torch.zeros_like(d), d) * inv_r
            pos = pos + t * t
            ge = g * -0.5 * (2.0 * t) * inv_r
            g_u.append(torch.where(d >= 0.0, ge, torch.zeros_like(ge)) * torch.sign(v[:, i]))
        lp = flux + -0.5 * pos
        # the backward: d lf, then d x
        glf = [-g for _ in range(nb)]
        z = (lf[ref] - ref_mean) * ref_inv
        glf[ref] = glf[ref] + -(g * z) * ref_inv
        for b in range(nb - 1):
            z = (lf[b] - lf[b + 1] - cm[b]) / cs[b]
            gc = -(g * z) / cs[b]
            glf[b] = glf[b] + gc
            glf[b + 1] = glf[b + 1] + -gc
        grad[:, off] = g_u[0]
        grad[:, off + 1] = g_u[1]
        for b in range(nb):
            grad[:, off + 2 + b] = glf[b] / f[b] * f[b] + g
        if galaxy:
            lt, ls, la = v[:, 2 + nb], v[:, 3 + nb], v[:, 4 + nb]
            theta, sigma, ab = sigmoid(lt), torch.exp(ls), sigmoid(la)
            lsig = torch.log(sigma)
            shape = ta1 * torch.log(theta) + tb1 * torch.log1p(-theta) + tnorm
            shape = shape + normal((lsig - s_mean) * s_inv, s_log) - lsig
            shape = shape + (aa1 * torch.log(ab) + ab1 * torch.log1p(-ab) + anorm)
            lp = lp + (shape - log_pi)
            ljd = ljd + (-lt - 2.0 * softplus(-lt)) + ls + (-la - 2.0 * softplus(-la))
            z = (lsig - s_mean) * s_inv
            g_lsig = -(g * z) * s_inv
            grad[:, off + 2 + nb] = (beta_grad(theta, ta1, tb1) * (1.0 - theta) * theta
                                     + sig_ljd_grad(lt))
            grad[:, off + 3 + nb] = (g_lsig / sigma + -g / sigma) * sigma + g
            grad[:, off + 4 + nb] = beta_grad(ab, aa1, ab1) * (1.0 - ab) * ab + sig_ljd_grad(la)
            grad[:, off + 5 + nb] = 0.0
        total = total + lp + ljd
    return total, grad


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_cpu_branch_is_the_plain_prior_bit_for_bit(name):
    scene, vecs = _problem(name, 7, "far")
    priors = SourcePriors()
    prep = sp.ScenePrior(scene, priors, "cpu")
    g = _cotangent(7, 1)
    assert torch.equal(prep(vecs), _crowded_logprior(scene, priors, vecs))
    x = vecs.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(prep(x), x, g)
    assert torch.equal(got, _plain_grad(scene, priors, vecs, g))
    assert prep.consts is None and sp.scene_prior_fwd_cuda.launches == 0


@pytest.mark.parametrize("kind", ["near", "far", "steep"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_algebra_matches_plain_prior_and_autograd(name, kind):
    scene, vecs = _problem(name, 64, kind, seed=5)
    priors = SourcePriors()
    g = _cotangent(64, 9)
    value, grad = _kernel_algebra(scene, priors, vecs, g)
    want = _crowded_logprior(scene, priors, vecs)
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(value, want, **VALUE_TOL)
    _assert_grad_close(grad, scene, priors, vecs, g)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_algebra_is_non_finite_where_the_plain_prior_is(name):
    scene, vecs = _problem(name, 96, "saturated", seed=3)
    priors = SourcePriors()
    g = _cotangent(96, 4)
    value, grad = _kernel_algebra(scene, priors, vecs, g)
    want = _crowded_logprior(scene, priors, vecs)
    assert not bool(torch.isfinite(want).all()) and bool(torch.isfinite(want).any())
    assert torch.equal(torch.isfinite(value), torch.isfinite(want))
    torch.testing.assert_close(value, want, equal_nan=True, **VALUE_TOL)
    assert torch.equal(torch.isfinite(grad), torch.isfinite(_plain_grad(scene, priors, vecs, g)))


def test_packed_constants_follow_the_priors():
    from celeste_tpu_torch.model.priors import FluxPrior, GalaxyShapePrior, PositionPrior

    priors = SourcePriors(flux=FluxPrior(log_ref_mean=2.5, log_ref_std=2.0, ref_band=4,
                                         color_mean=(0.1, 0.2, 0.3, 0.4),
                                         color_std=(1.0, 2.0, 4.0, 8.0)),
                          position=PositionPrior(halfwidth_arcsec=30.0, rolloff=2.0),
                          shape=GalaxyShapePrior(theta_a=2.0, theta_b=3.0, ab_a=1.5, ab_b=0.5))
    scene = CrowdedScene(kinds=("star", "galaxy", "star"), n_bands=3)
    consts, table, ref = sp.pack_constants(scene, priors)
    assert consts.dtype == np.float32 and consts.size == 15 + 3 * 2
    assert ref == 2 and table.tolist() == [0, 0, 1, 5, 0, 14]
    np.testing.assert_array_equal(consts[[0, 1, 3, 4, 5, 6]], [2.5, 0.5, 30.0, 0.5, 1.0, 2.0])
    assert consts[7] == np.float32(math.lgamma(5.0) - math.lgamma(2.0) - math.lgamma(3.0))
    np.testing.assert_array_equal(consts[15:19], np.float32([0.1, 0.2, 1.0, 2.0]))
    np.testing.assert_allclose(consts[19:], np.log([1.0, 2.0]), atol=1e-7)
    # the flux prior's clamp of the reference slot, and too few colours
    assert sp.pack_constants(CrowdedScene(kinds=("star",), n_bands=2), priors)[2] == 1
    with pytest.raises(ValueError):
        sp.pack_constants(CrowdedScene(kinds=("star",), n_bands=6), priors)


def _tiled_logdensity(priors):
    """A tiled log density of two sources on a small stamp, on the CPU."""
    from celeste_tpu_torch.model.stamp import Stamp
    from celeste_tpu_torch.mog import isotropic
    from celeste_tpu_torch.parallel.crowded import make_tiled_crowded_logdensity

    kw = dict(dtype=torch.float32)
    stamp = Stamp(counts=torch.full((32, 32), 150.0, **kw), sky=torch.full((32, 32), 150.0, **kw),
                  iota=torch.tensor(800.0), mask=torch.ones(32, 32, **kw),
                  psf=isotropic([0.7, 0.3], [[0.0, 0.0]] * 2, [1.5, 4.0], "cpu"),
                  wcs_A=torch.eye(2, **kw) / 0.396, wcs_p0=torch.tensor([16.0, 16.0]), band=2)
    scene = CrowdedScene(kinds=("star", "galaxy"), n_bands=1)
    logd, _ = make_tiled_crowded_logdensity(scene, stamp, band=0,
                                            positions_px=[[14.0, 15.0], [18.0, 17.0]],
                                            priors=priors)
    return logd, scene


def test_tiled_logdensity_takes_the_pair_unless_the_colours_are_a_gmm(monkeypatch):
    from celeste_tpu_torch.model.color_prior import default_star_gmm
    from celeste_tpu_torch.model.priors import FluxPrior

    calls = []
    monkeypatch.setattr(sp.ScenePrior, "__call__",
                        lambda self, vecs: calls.append(self) or self.plain(vecs))
    for priors, n_calls in ((SourcePriors(), 1),
                            (SourcePriors(flux=FluxPrior(color_gmm=default_star_gmm())), 0)):
        logd, scene = _tiled_logdensity(priors)
        vecs = _states(scene, 3, "near", 2)
        del calls[:]
        assert bool(torch.isfinite(logd(vecs)).all())
        assert len(calls) == n_calls
    with pytest.raises(ValueError):
        sp.ScenePrior(scene, priors, "cpu")


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
    """Config 5's log density, scene and truth in r and in g, r, i."""
    from celeste_tpu_torch.bench.config5 import build_config5, build_config5_multiband

    logd, _, vec, info = build_config5(device=cuda)
    logd3, _, vec3, info3 = build_config5_multiband(device=cuda)
    return {"c5_r": (info["scene"], vec, logd), "c5_gri": (info3["scene"], vec3, logd3)}


CARD_SCENES = ["c5_r", "c5_gri"] + sorted(SCENES)


def _card_problem(c5, cuda, name, b, kind="near", seed=0):
    """(ScenePrior, states [b, D]) on the card: config 5's scenes at their
    truth plus noise of 0.01 ("near") or drawn as the random scenes are."""
    if name in SCENES:
        scene, vecs = _problem(name, b, kind, seed, cuda)
    elif kind == "near":
        scene, vec, _ = c5[name]
        noise = np.random.default_rng(seed).normal(0.0, 0.01, (b, vec.shape[0]))
        vecs = vec[None] + torch.as_tensor(noise, dtype=torch.float32, device=cuda)
    else:
        scene = c5[name][0]
        vecs = _states(scene, b, kind, seed, cuda)
    return sp.ScenePrior(scene, SourcePriors(), cuda), vecs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near", "far", "steep"])
@pytest.mark.parametrize("name", CARD_SCENES)
def test_kernel_values_match_plain(cuda, c5, name, kind):
    prep, vecs = _card_problem(c5, cuda, name, 1001, kind)
    got = sp.scene_prior_fwd_cuda(prep, vecs)
    want = prep.plain(vecs)
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, **VALUE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near", "far", "steep"])
@pytest.mark.parametrize("name", CARD_SCENES)
def test_kernel_gradient_matches_plain_autograd(cuda, c5, name, kind):
    prep, vecs = _card_problem(c5, cuda, name, 777, kind, seed=2)
    g = _cotangent(777, 5, cuda)
    x = vecs.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(prep(x), x, g)
    _assert_grad_close(got, prep.scene, prep.priors, vecs, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_SCENES)
def test_kernel_is_non_finite_where_the_plain_prior_is(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 513, "saturated", seed=3)
    g = _cotangent(513, 4, cuda)
    got = sp.scene_prior_fwd_cuda(prep, vecs)
    want = prep.plain(vecs)
    assert not bool(torch.isfinite(want).all())
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    torch.testing.assert_close(got, want, equal_nan=True, **VALUE_TOL)
    grad = sp.scene_prior_bwd_cuda(prep, vecs, g)
    want_g = _plain_grad(prep.scene, prep.priors, vecs, g)
    assert torch.equal(torch.isfinite(grad), torch.isfinite(want_g))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 63, 65, 4099])
def test_chain_counts_off_the_block(cuda, c5, b):
    prep, vecs = _card_problem(c5, cuda, "c5_gri", b, seed=b)
    g = _cotangent(b, b, cuda)
    torch.testing.assert_close(sp.scene_prior_fwd_cuda(prep, vecs), prep.plain(vecs),
                               **VALUE_TOL)
    _assert_grad_close(sp.scene_prior_bwd_cuda(prep, vecs, g), prep.scene, prep.priors, vecs, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri", "galaxies, 5 bands"])
def test_two_calls_give_equal_bits(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 4099, seed=3)
    g = _cotangent(4099, 9, cuda)
    fwd = [sp.scene_prior_fwd_cuda(prep, vecs) for _ in range(2)]
    bwd = [sp.scene_prior_bwd_cuda(prep, vecs, g) for _ in range(2)]
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(bwd[0], bwd[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri"])
def test_one_forward_and_one_backward_launch_per_gradient(cuda, c5, name):
    _, vec, logd = c5[name]
    x = (vec[None] + torch.zeros(513, vec.shape[0], device=cuda)).requires_grad_(True)
    before = (sp.scene_prior_fwd_cuda.launches, sp.scene_prior_bwd_cuda.launches)
    lp = logd(x)
    mid = (sp.scene_prior_fwd_cuda.launches, sp.scene_prior_bwd_cuda.launches)
    (g,) = torch.autograd.grad(lp.sum(), x)
    after = (sp.scene_prior_fwd_cuda.launches, sp.scene_prior_bwd_cuda.launches)
    assert (mid[0] - before[0], mid[1] - before[1]) == (1, 0)
    assert (after[0] - mid[0], after[1] - mid[1]) == (0, 1)
    assert bool(torch.isfinite(lp).all()) and bool(torch.isfinite(g).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c5_r", "c5_gri"])
def test_no_host_sync_in_the_prior(cuda, c5, name):
    prep, vecs = _card_problem(c5, cuda, name, 1024)
    g = _cotangent(1024, 1, cuda)
    x = vecs.clone().requires_grad_(True)
    prep(x)                                   # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (grad,) = torch.autograd.grad(prep(x), x, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(grad).all())


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda, c5):
    prep, vecs = _card_problem(c5, cuda, "c5_r", 16)
    for bad in (vecs.double(), vecs[:, :-1].contiguous(), vecs.cpu(),
                vecs.t().contiguous().t()):
        with pytest.raises(ValueError):
            sp.scene_prior_fwd_cuda(prep, bad)
    g = torch.ones(16, device=cuda)
    for bad in (g[:-1], g.double(), g.cpu()):
        with pytest.raises(ValueError):
            sp.scene_prior_bwd_cuda(prep, vecs, bad)
    cpu_prep = sp.ScenePrior(prep.scene, prep.priors, "cpu")
    with pytest.raises(ValueError):
        sp.scene_prior_fwd_cuda(cpu_prep, vecs)
