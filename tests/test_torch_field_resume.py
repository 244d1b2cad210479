"""The port's field pipeline on the CPU: checkpoint and resume, and the
entry point.

- Checkpoint and resume (tests/test_field.py:432) at that test's own
  settings: a run stopped after its first sampling segment and rerun on the
  checkpoint equals the unbroken run bitwise, a checkpoint of another run is
  refused, and a checkpoint path without segments is refused.  This is the
  port's contract (streams by group, phase and segment).  JAX's
  segmented-against-monolithic test (tests/test_field.py:386) holds in the
  port in distribution only: a segmented run draws from its segments'
  streams, an unsegmented one from one stream per phase; it runs uncut on
  the card (tests/test_torch_kernels_cuda.py), as do the posterior recovery
  (:206), the multiband joint (:350) and the survey-scale accuracy (:487).
  The sharded groups (:320) are in tests/test_torch_chees_groups.py.
- The entry point: ``config=field`` runs on the CPU only when asked, at
  the config's width, cut in steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from celeste_tpu_torch import field as field_module
from celeste_tpu_torch.experiments import CONFIGS, ExperimentConfig, run_experiment
from celeste_tpu_torch.field import FieldConfig, run_field_pipeline
from celeste_tpu_torch.utils.metrics import MetricsLogger

import torch_field_workers as w
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

RESUME = dict(n_chains=8, probe_warmup=20, probe_steps=8, n_warmup=20, n_steps=20, map_steps=60,
              sample_segment=8, warmup_window=9)


def _run(cfg, logger=None):
    scene, _ = w.two_group_frame()
    return run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg, priors=w.PRIORS,
                              logger=logger)


def test_field_checkpoint_resume_bitwise(tmp_path):
    """Stop the pipeline after its first sampling segment (a logger that
    raises stands in for a preemption), rerun with the same path: the
    resumed catalog and samples are bitwise the unbroken segmented run's."""
    class Stop(Exception):
        pass

    class StopAfterFirstSegment(MetricsLogger):
        def log(self, event, **kw):
            super().log(event, **kw)
            if event == "field_sample_segment":
                raise Stop

    ck = str(tmp_path / "field_ck.npz")
    cat_u, art_u = _run(FieldConfig(**w.SMALL | RESUME))
    with pytest.raises(Stop):
        _run(FieldConfig(**w.SMALL | RESUME, checkpoint_path=ck), StopAfterFirstSegment())
    cat_r, art_r = _run(FieldConfig(**w.SMALL | RESUME, checkpoint_path=ck))
    np.testing.assert_array_equal(art_u["samples"], art_r["samples"])
    for eu, er in zip(cat_u, cat_r):
        assert eu.kind == er.kind
        np.testing.assert_array_equal(eu.flux_mean, er.flux_mean)
        np.testing.assert_array_equal(eu.du_mean, er.du_mean)
    # a stale checkpoint of a different run is refused loudly
    with pytest.raises(ValueError, match="different run"):
        _run(FieldConfig(**w.SMALL | RESUME | dict(seed=99), checkpoint_path=ck))
    # checkpointing without segments has no boundary to save at
    with pytest.raises(ValueError, match="requires cfg.sample_segment"):
        _run(FieldConfig(**w.SMALL | RESUME | dict(sample_segment=None), checkpoint_path=ck))


def test_field_entry_point_runs_on_the_cpu_only_when_asked(monkeypatch):
    """``config=field`` through ``run_experiment`` on the CPU at the config's
    width (the 96x96 frame's 5 sources, 32 chains, the type switch on), cut
    in steps only: the entry point's warmup and steps, and through a
    ``FieldConfig`` with fewer probe, type-switch and leapfrog steps.  It
    finds JAX's catalog (4 stars and the galaxy, 4 groups, the blend
    sampled as one) and returns JAX's result keys; without ``device=cpu``
    it needs CUDA."""
    @dataclasses.dataclass
    class CutInSteps(FieldConfig):
        probe_warmup: int = 2
        probe_steps: int = 2
        max_leapfrog: int = 2
        type_switch_steps: int = 10

    monkeypatch.setattr(field_module, "FieldConfig", CutInSteps)
    cfg = dataclasses.replace(CONFIGS["field"], n_warmup=2, n_steps=6, device="cpu")
    assert (cfg.n_sources, cfg.n_chains, cfg.type_switch) == (5, 32, True)
    res = run_experiment(cfg)
    assert set(res) >= {"kinds", "group", "du_mean", "flux_mean", "run"}
    assert sorted(res["kinds"]) == ["galaxy", "star", "star", "star", "star"]
    art = res["run"]["artifacts"]
    assert art["n_groups"] == 4 and art["s_max"] == 2
    pair = [g for g in set(res["group"].tolist()) if list(res["group"]).count(g) == 2]
    assert len(pair) == 1
    assert sorted(res["kinds"][res["group"] == pair[0]]) == ["galaxy", "star"]
    assert art["samples"].shape == (4, 32, 6, 2 * 7)
    assert np.isfinite(art["samples"]).all() and np.isfinite(res["flux_mean"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            run_experiment(ExperimentConfig(name="field", device="cuda"))
