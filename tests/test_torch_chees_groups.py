"""ChEES over groups x chains (``inference/chees.py`` with ``Groups``, the
batched whitening of ``inference/whiten.py``) and the field's groups mesh,
the port's counterpart of JAX's ``chees_warmup`` / ``run_chees_ensemble``
vmapped over fit groups (``celeste_tpu/field.py:919-942``, ``:980-1028``).

- The single ensemble is the G = 1 case of the one ChEES path: a call with
  ``gen`` equals one with ``Groups([gen], B)`` bitwise (eps and T 0-d
  tensors, info fields [n_steps], against [1] and [1, n_steps]).
- Several groups, each with its own (eps, T), dual averaging and Adam, and
  a leapfrog loop frozen per group at its own count, equal each group run
  alone, bitwise, on a Gaussian (the log density is per row, so a group's
  rows see nothing of the others').
- The per-group moments and whitening equal each group's own.
- The field's fit groups sharded over a CPU gloo world of 2 equal the
  single-device run bitwise: a group draws from its own streams.
"""

import numpy as np
import pytest
import torch

from celeste_tpu_torch.inference.chees import Groups, chees_warmup, run_chees_ensemble
from celeste_tpu_torch.inference.whiten import ensemble_covariance, whiten_logdensity
from celeste_tpu_torch.parallel.mesh import launch
from celeste_tpu_torch.utils.rng import seeded_generator

import torch_field_workers as w
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

D, B = 5, 16
# per-group scales of an axis-aligned Gaussian: wide, narrow and mixed, so
# the groups adapt different step sizes and trajectory lengths
SCALES = torch.tensor([[0.5, 1.0, 2.0, 3.0, 0.1], [0.05, 0.05, 0.1, 0.1, 0.05],
                       [4.0, 1.0, 0.3, 2.0, 1.0]])


def _logd(scales):
    """A Gaussian per group on rows stacked set-major, [G B, D] -> [G B]."""
    rows = scales.repeat_interleave(B, dim=0)
    return lambda x: -0.5 * torch.sum((x / rows[:x.shape[0]]) ** 2, -1)


def _run(gens, scales, x0, n_warmup=30, n_steps=20, max_leapfrog=16):
    groups = Groups(gens, B)
    logd = _logd(scales)
    st, eps, traj = chees_warmup(None, logd, x0, n_warmup=n_warmup, init_step_size=0.1,
                                 max_leapfrog=max_leapfrog, groups=groups)
    samples, st, info = run_chees_ensemble(None, logd, st, n_steps, eps, traj,
                                           max_leapfrog=max_leapfrog, groups=groups)
    return samples, st, eps, traj, info


def test_one_group_is_the_existing_path_bitwise():
    x0 = 0.1 * torch.randn(B, D, generator=torch.Generator().manual_seed(0))
    logd = _logd(SCALES[:1])
    gen = seeded_generator("cpu", 3, 1)
    st, eps, traj = chees_warmup(gen, logd, x0, n_warmup=30, init_step_size=0.1, max_leapfrog=16)
    samples, st2, info = run_chees_ensemble(gen, logd, st, 20, float(eps), float(traj),
                                            max_leapfrog=16)
    g_samples, g_st2, g_eps, g_traj, g_info = _run([seeded_generator("cpu", 3, 1)], SCALES[:1],
                                                   x0)
    assert torch.equal(g_eps, eps.reshape(1)) and torch.equal(g_traj, traj.reshape(1))
    assert torch.equal(g_samples, samples) and torch.equal(g_st2.xs, st2.xs)
    assert torch.equal(g_st2.logps, st2.logps) and torch.equal(g_st2.grads, st2.grads)
    for got, want in zip(g_info, info):
        assert torch.equal(got[0], want)


def test_groups_equal_each_group_alone():
    """Three groups of different scales in one batch: per-group (eps, T)
    differ, so the leapfrog counts differ within steps and the groups done
    first are frozen; every group's chain, (eps, T) and info equal its own
    single-group run bitwise."""
    x0 = 0.1 * torch.randn(3 * B, D, generator=torch.Generator().manual_seed(1))
    gens = [seeded_generator("cpu", 9, 5, g) for g in range(3)]
    samples, st, eps, traj, info = _run(gens, SCALES, x0)
    assert len(set(eps.tolist())) == 3
    leaps = info.n_leapfrog
    assert bool((leaps.max(0).values > leaps.min(0).values).any()), "no step had mixed counts"
    for g in range(3):
        rows = slice(g * B, (g + 1) * B)
        alone = _run([seeded_generator("cpu", 9, 5, g)], SCALES[g:g + 1], x0[rows])
        assert torch.equal(alone[0], samples[rows])
        assert torch.equal(alone[1].xs, st.xs[rows])
        assert torch.equal(alone[2], eps[g:g + 1]) and torch.equal(alone[3], traj[g:g + 1])
        for got, want in zip(info, alone[4]):
            assert torch.equal(got[g:g + 1], want)
    # and the groups sample their own targets
    sd = samples[:, 5:].reshape(3, -1, D).std(1)
    assert bool(((sd / SCALES - 1).abs() < 0.6).all()), sd


def test_group_moments_and_whitening_equal_each_groups_own():
    xs = torch.randn(3 * B, 7, D, generator=torch.Generator().manual_seed(2)) * SCALES.repeat_interleave(B, 0)[:, None]
    m, c = ensemble_covariance(xs, ridge=1e-4, groups=3)
    assert m.shape == (3, D) and c.shape == (3, D, D)
    logd = _logd(SCALES)
    logd_z, to_x, to_z = whiten_logdensity(logd, m, c)
    z = torch.randn(3 * B, D, generator=torch.Generator().manual_seed(3))
    for g in range(3):
        rows = slice(g * B, (g + 1) * B)
        mg, cg = ensemble_covariance(xs[rows], ridge=1e-4)
        torch.testing.assert_close(m[g], mg, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(c[g], cg, rtol=1e-6, atol=1e-7)
        lz, tx, tz = whiten_logdensity(_logd(SCALES[g:g + 1]), mg, cg)
        torch.testing.assert_close(to_x(z)[rows], tx(z[rows]), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(to_z(z)[rows], tz(z[rows]), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(logd_z(z)[rows], lz(z[rows]), rtol=1e-6, atol=1e-5)
    # samples [G B, n, D] map by the same groups
    sx = to_x(xs)
    torch.testing.assert_close(sx[:B], whiten_logdensity(logd, m[0], c[0])[1](xs[:B]),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def field_single():
    return w.field_run(False)


def test_sharded_groups_equal_the_single_device_run(field_single):
    """The two-group frame's groups over a gloo world of 2 (one group per
    rank, gathered by one all-reduce): samples and catalog bitwise the
    single-device run's."""
    ranks = launch(w.field_run, 2, True)
    assert field_single["n_groups"] == 2
    for r in ranks:
        assert r["samples"].shape == field_single["samples"].shape
        np.testing.assert_array_equal(r["samples"], field_single["samples"])
        np.testing.assert_array_equal(r["du_mean"], field_single["du_mean"])
        np.testing.assert_array_equal(r["flux_mean"], field_single["flux_mean"])
        assert r["kinds"] == field_single["kinds"]


def test_sharded_groups_pad_with_dead_groups(field_single):
    """With three ranks the two groups are padded by a dead group (mask 0,
    alive 0): the real groups' samples are unchanged, the padding dropped."""
    ranks = launch(w.field_run, 3, True)
    for r in ranks:
        np.testing.assert_array_equal(r["samples"], field_single["samples"])
