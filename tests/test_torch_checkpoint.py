"""The port's checkpoints, resume, guards and warm-start caches
(``celeste_tpu_torch.utils``, ``experiments.run_experiment``'s
``checkpoint_every`` / ``resume``, ``bench.config5``'s cached warm starts), on
the CPU, with the semantics of the JAX package's tests
(tests/test_checkpoint_experiments.py, tests/test_utils_and_cli.py,
tests/test_prep_cache.py).

Tolerances: every resume, round trip and cache hit is bitwise (array
equality); the JAX-checkpoint reader returns the saved arrays bitwise.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu_torch.bench.config5 import (
    _chees_warm_cached,
    config5_warmup_and_whiten,
    config5_warmup_and_whiten_cached,
    measure_chees_z,
    measure_nuts_z,
)
from celeste_tpu_torch.experiments import CONFIGS
from celeste_tpu_torch.inference import mh_init, mh_kernel, run_chains_ensemble
from celeste_tpu_torch.inference.mh import MHState
from celeste_tpu_torch.interop import load_jax_checkpoint
from celeste_tpu_torch.run import main
from celeste_tpu_torch.utils import checked_logdensity, load_checkpoint, save_checkpoint, timed

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

# a cut star_single run: every sampler's resume on a few chains and steps
RUN = ["config=star_single", "device=cpu", "n_chains=6", "n_warmup=10", "n_leapfrog=4"]


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    path = str(tmp_path / "s.npz")
    gen = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(3, generator=gen), "st": MHState(x=torch.randn((4, 2), generator=gen),
                                                                logp=torch.randn(4, generator=gen)),
             "n": np.arange(5, dtype=np.int32), "t": 7, "lst": [torch.zeros(2, dtype=torch.int64)]}
    save_checkpoint(path, state, step=3, extra={"k": "v"})
    got, step, extra = load_checkpoint(path, state)
    assert step == 3 and extra == {"k": "v"}
    assert isinstance(got["st"], MHState) and got["t"] == 7 and isinstance(got["t"], int)
    for a, b in ((got["a"], state["a"]), (got["st"].x, state["st"].x),
                 (got["st"].logp, state["st"].logp), (got["lst"][0], state["lst"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(got["n"], state["n"])


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    """Same leaf count but a different structure, shape or dtype fails
    loudly, not silently mapping arrays into the wrong slots."""
    path = str(tmp_path / "s.npz")
    state = {"a": torch.arange(3, dtype=torch.float32), "b": torch.zeros((2, 2))}
    save_checkpoint(path, state, step=1)
    got, step, _ = load_checkpoint(path, state)
    assert step == 1 and torch.equal(got["a"], torch.tensor([0.0, 1.0, 2.0]))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, {"a": state["a"], "c": state["b"]})
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, MHState(x=state["a"], logp=state["b"]))
    with pytest.raises(ValueError, match="leaf"):
        load_checkpoint(path, {"a": torch.zeros(4), "b": state["b"]})
    with pytest.raises(ValueError, match="leaf"):
        load_checkpoint(path, {"a": torch.zeros(3, dtype=torch.int32), "b": state["b"]})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, {"a": state["a"]})


def test_checkpoint_exact_resume(tmp_path):
    """save -> load -> continue equals an uninterrupted run, bitwise."""
    def target(x):
        return -0.5 * torch.sum(x * x, -1)

    kern = mh_kernel(target, step_scales=torch.full((2,), 0.5))
    init = mh_init(torch.randn((4, 2), generator=torch.Generator().manual_seed(0)), target)
    g1, g2 = torch.Generator().manual_seed(41), torch.Generator().manual_seed(42)
    _, mid, _ = run_chains_ensemble(g1, kern, init, n_steps=20)
    s_b, fin, _ = run_chains_ensemble(g2, kern, mid, n_steps=20)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, mid, step=20)
    loaded, step, _ = load_checkpoint(path, mid)
    assert step == 20
    s_b2, fin2, _ = run_chains_ensemble(torch.Generator().manual_seed(42), kern, loaded, 20)
    assert torch.equal(s_b, s_b2) and torch.equal(fin.x, fin2.x)


@pytest.mark.parametrize("sampler", ["mh", "hmc", "chees"])
def test_resumed_run_equals_unbroken(tmp_path, sampler):
    """run_experiment stopped after segment 2 of 4 and resumed from its
    checkpoint gives the unbroken run's samples, mean and R-hat bitwise."""
    base = RUN + [f"sampler={sampler}", "checkpoint_every=10"]
    full = main(base + ["n_steps=40", f"out={tmp_path}/full"])
    main(base + ["n_steps=20", f"out={tmp_path}/half"])
    assert os.path.exists(f"{tmp_path}/half.ckpt.npz")
    resumed = main(base + ["n_steps=40", f"resume={tmp_path}/half.ckpt.npz",
                           f"out={tmp_path}/resumed"])
    for key in ("samples", "mean", "rhat"):
        np.testing.assert_array_equal(resumed[key], full[key])
    events = [json.loads(line)["event"]
              for line in open(f"{tmp_path}/resumed.metrics.jsonl").read().splitlines()]
    assert "resume" in events and events.count("checkpoint") == 2


def test_resume_complete_missing_segments_and_nothing_to_run(tmp_path):
    """Resuming a completed run re-summarizes the stored chain; without the
    segments file the run logs ``resume_without_segments`` and covers only
    what it samples; with nothing left to sample and no segments it exits."""
    base = RUN + ["sampler=mh", "checkpoint_every=10"]
    first = main(base + ["n_steps=20", f"out={tmp_path}/a"])
    done = main(base + ["n_steps=20", f"resume={tmp_path}/a.ckpt.npz", f"out={tmp_path}/b"])
    np.testing.assert_array_equal(done["samples"], first["samples"])
    events = [json.loads(line)["event"]
              for line in open(f"{tmp_path}/b.metrics.jsonl").read().splitlines()]
    assert "already_complete" in events
    os.remove(f"{tmp_path}/a.ckpt.npz.segments.npz")
    tail = main(base + ["n_steps=40", f"resume={tmp_path}/a.ckpt.npz", f"out={tmp_path}/c"])
    assert tail["samples"].shape[1] == 20
    events = [json.loads(line)["event"]
              for line in open(f"{tmp_path}/c.metrics.jsonl").read().splitlines()]
    assert "resume_without_segments" in events
    with pytest.raises(SystemExit):
        main(base + ["n_steps=20", f"resume={tmp_path}/a.ckpt.npz", f"out={tmp_path}/d"])


def test_checkpoint_options_checked():
    from celeste_tpu_torch.experiments import run_experiment

    cfg = CONFIGS["star_single"]
    with pytest.raises(ValueError, match="divide"):
        run_experiment(type(cfg)(**{**cfg.__dict__, "device": "cpu", "n_steps": 30,
                                    "checkpoint_every": 20}))


def test_checked_logdensity_raises_on_nan():
    def logd(x):
        return torch.where(x[:, 0] > 0, -0.5 * torch.sum(x * x, -1), torch.log(x[:, 0] * 0 - 1))

    checked, run = checked_logdensity(logd)
    ok = torch.ones((3, 2))
    assert torch.equal(run(ok), -0.5 * torch.sum(ok * ok, -1))
    bad = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    err, _ = checked(bad)
    assert "chains [1]" in err
    with pytest.raises(FloatingPointError, match="non-finite log density"):
        run(bad)


def test_timed_on_cpu():
    seconds, out = timed(lambda x: x * 2, torch.ones(3), iters=3, warmup=1)
    assert seconds >= 0.0 and torch.equal(out, torch.full((3,), 2.0))


def test_jax_checkpoint_reader(tmp_path):
    """A sampler state that the JAX package checkpointed loads into the
    port's state of the same sampler, bitwise; a wrong target raises."""
    from celeste_tpu.inference.mh import MHState as JMHState
    from celeste_tpu.utils.checkpoint import save_checkpoint as j_save

    path = str(tmp_path / "j.npz")
    x = jax.random.normal(jax.random.key(0), (5, 3))
    j_save(path, JMHState(x=x, logp=jnp.sum(x, -1)), step=4)
    like = MHState(x=torch.zeros((5, 3)), logp=torch.zeros(5))
    got, step, _ = load_jax_checkpoint(path, like)
    assert step == 4
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(x))
    np.testing.assert_array_equal(got.logp.numpy(), np.asarray(jnp.sum(x, -1)))
    with pytest.raises(ValueError, match="leaf"):
        load_jax_checkpoint(path, MHState(x=torch.zeros((4, 3)), logp=torch.zeros(4)))


# ---------------------------------------------------------------------------
# the warm-start caches (tests/test_prep_cache.py's semantics, D = 4, 8 chains)
# ---------------------------------------------------------------------------

_SCALES = torch.tensor([0.5, 1.0, 2.0, 4.0])


def _logd(x):
    return -0.5 * torch.sum((x / _SCALES) ** 2, -1)


def _logd_shifted(x):
    # same geometry, +5 nats everywhere: what a likelihood-code change
    # looks like to the cached states' stored logp
    return _logd(x) + 5.0


VEC = torch.zeros(4)
KW = dict(n_chains=8, n_warmup=10, warmup_window=5, n_zwarm=4, probe_steps=4, verbose=False)


def test_prep_cache_roundtrip_is_bitwise(tmp_path):
    path = str(tmp_path / "prep.npz")
    p1 = config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    assert os.path.exists(path)
    p2 = config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    for f in ("x", "logp", "grad"):
        assert torch.equal(getattr(p2["states_z"], f), getattr(p1["states_z"], f))
        assert torch.equal(getattr(p2["states_x"], f), getattr(p1["states_x"], f))
    assert p2["step_z"] == p1["step_z"] and p2["step_size"] == p1["step_size"]
    assert torch.equal(p2["inv_mass"], p1["inv_mass"]) and p2["probe_gap"] < 1.0
    nuts = measure_nuts_z(p2, n_steps=8, run_segment=4)
    assert np.isfinite(nuts["min_ess_per_s"]) and nuts["divergence"] < 0.5
    chees = measure_chees_z(p2, n_steps=8, run_segment=4, warmup_iters=4, warmup_window=2)
    assert np.isfinite(chees["min_ess_per_s"]) and 0.0 < chees["accept"] <= 1.0


def test_prep_cache_matches_uncached(tmp_path):
    path = str(tmp_path / "prep.npz")
    fresh = config5_warmup_and_whiten(_logd, VEC, **{k: v for k, v in KW.items()
                                                     if k != "verbose"})
    cached = config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    hit = config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    for a in (cached, hit):
        assert torch.equal(a["states_z"].x, fresh["states_z"].x)
        assert a["step_z"] == fresh["step_z"]


def test_prep_cache_invalidates_on_knob_change(tmp_path):
    path = str(tmp_path / "prep.npz")
    p1 = config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    kw2 = dict(KW, n_warmup=12)
    p2 = config5_warmup_and_whiten_cached(_logd, VEC, path, **kw2)
    assert not torch.equal(p2["states_z"].x, p1["states_z"].x)
    p3 = config5_warmup_and_whiten_cached(_logd, VEC, path, **kw2)
    assert torch.equal(p3["states_z"].x, p2["states_z"].x)


def test_prep_cache_live_probe_catches_stale_target(tmp_path, capsys):
    """Same fingerprint, changed density: the live probe rejects the cached
    ensemble (its stored logp is 5 nats off) and warms up afresh."""
    path = str(tmp_path / "prep.npz")
    config5_warmup_and_whiten_cached(_logd, VEC, path, **KW)
    p2 = config5_warmup_and_whiten_cached(_logd_shifted, VEC, path, **KW)
    assert "live logd_z probe off by 5" in capsys.readouterr().err
    fresh = config5_warmup_and_whiten(_logd_shifted, VEC, **{k: v for k, v in KW.items()
                                                             if k != "verbose"})
    assert torch.equal(p2["states_z"].x, fresh["states_z"].x)
    p3 = config5_warmup_and_whiten_cached(_logd_shifted, VEC, path, **KW)
    assert torch.equal(p3["states_z"].logp, p2["states_z"].logp)


def test_chees_warm_cache_roundtrip_and_invalidation(tmp_path):
    prep = config5_warmup_and_whiten_cached(_logd, VEC, str(tmp_path / "prep.npz"), **KW)
    path = str(tmp_path / "chees.npz")
    st1, eps1, traj1 = _chees_warm_cached(prep, path, 4, 2, 16, False)
    assert os.path.exists(path)
    st2, eps2, traj2 = _chees_warm_cached(prep, path, 4, 2, 16, False)
    assert torch.equal(st2.xs, st1.xs) and eps2 == eps1 and traj2 == traj1
    st3, _, _ = _chees_warm_cached(prep, path, 6, 2, 16, False)       # knob change
    assert not torch.equal(st3.xs, st1.xs)
    prep_shift = dict(prep, logd_z=lambda z: prep["logd_z"](z) + 5.0)
    st4, _, _ = _chees_warm_cached(prep_shift, path, 6, 2, 16, False)  # live probe rejects
    assert not torch.equal(st4.logps, st3.logps)
    out = measure_chees_z(prep, n_steps=8, run_segment=4, warmup_iters=4, warmup_window=2,
                          max_leapfrog=16, warm_cache_path=path)
    assert np.isfinite(out["min_ess_per_s"]) and 0.0 < out["accept"] <= 1.0
