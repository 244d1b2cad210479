"""The stamp kernels of ``celeste_tpu_torch/csrc/mog_field.cu`` against
their plain PyTorch versions, on an NVIDIA GPU.

Every test here needs the card: it carries the ``cuda`` marker and skips
where CUDA is absent (decided in the ``cuda`` fixture, not at import).  The
file imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda

Tolerances are those of the JAX package's kernel tests
(tests/test_pallas_kernel.py): values rtol 2e-6 with atol 0.5 for stars and
1.0 for galaxies (sums of ~640 fp32 terms of magnitude ~1e3 in another
order); gradients rtol 5e-4, atol 5e-2.
"""

import numpy as np
import pytest
import torch

from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu_torch.kernels import mog_field as mf

pytestmark = pytest.mark.cuda

TOL = {"star": dict(rtol=2e-6, atol=0.5), "galaxy": dict(rtol=2e-6, atol=1.0)}
GRAD_TOL = dict(rtol=5e-4, atol=5e-2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda:0")


def _planes(kind, n, device, seed=0):
    if kind == "star":
        src = star_source(u=(30.0001, 9.9999), flux_r=25.0)
        scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=3, device=device)
        extra = []
    else:
        src = galaxy_source(u=(30.0, 10.0), flux_r=60.0)
        scene = make_synthetic_stamp([src], shape=(25, 25), bands=(2,), seed=5, device=device)
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


def test_launch_error_raises_and_does_not_leak(cuda):
    """A stamp too large for a block's shared memory is refused by the C
    side; the wrapper raises, counts no launch, and the next launch works."""
    planes, pd, _, _ = _planes("star", 8, cuda)
    big = [torch.ones(1, 65536, device=cuda) for _ in range(5)]
    before = mf.launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        mf.loglik_fwd_cuda(*planes, *big)
    with pytest.raises(RuntimeError, match="launch failed"):
        mf.loglik_bwd_cuda(*planes, *big, torch.ones(8, device=cuda))
    assert mf.launch_counts() == before
    out = mf.loglik_fwd_cuda(*planes, *pd)
    torch.testing.assert_close(out, mf._loglik_torch(*planes, *pd), **TOL["star"])
