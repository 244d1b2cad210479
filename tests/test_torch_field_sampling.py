"""The port's field pipeline with its group sampler on the CPU: the
group-factorized posterior against the full-field joint
(tests/test_field.py:221), on the same two-group frame.  The plain kernel
is slow on the CPU, so the sampling is cut in steps: tests/test_field.py's
``_small_cfg`` samples 12 chains with 32 + 16 probe and 48 + 96 steps,
here its 12 chains with 12 + 8 and 12 + 24; the gates are that test's.  The
card runs the JAX test's settings uncut (tests/test_torch_kernels_cuda.py).
Checkpoint and resume and the entry point are in
tests/test_torch_field_resume.py.
"""

import numpy as np
import pytest

from celeste_tpu_torch.field import FieldConfig, run_field_pipeline

import torch_field_workers as w
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = dict(w.SMALL, n_chains=12, probe_warmup=12, probe_steps=8, n_warmup=12, n_steps=24,
             max_leapfrog=24, map_steps=150)


def _run(cfg, logger=None):
    scene, srcs = w.two_group_frame()
    return run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=cfg, priors=w.PRIORS,
                              logger=logger)


@pytest.fixture(scope="module")
def factorization_pair():
    cat_f, art_f = _run(FieldConfig(**SMALL))
    # a link radius spanning the frame -> one group = the exact full joint
    cat_j, art_j = _run(FieldConfig(**SMALL, link_radius_px=1e9))
    return (cat_f, art_f), (cat_j, art_j)


def test_group_factorization_matches_full_joint(factorization_pair):
    """With disjoint pixel ownership and neighbour-MAP effective skies the
    group-factorized posterior matches the full-field joint within MC
    error (tests/test_field.py's gates)."""
    (cat_f, art_f), (cat_j, art_j) = factorization_pair
    assert art_f["n_groups"] == 2 and art_j["n_groups"] == 1
    f = sorted(cat_f, key=lambda e: float(e.du_mean[0]))
    j = sorted(cat_j, key=lambda e: float(e.du_mean[0]))
    assert len(f) == len(j) == 3
    for ef, ej in zip(f, j):
        sf, sj = float(ef.flux_std[0]), float(ej.flux_std[0])
        mf, mj = float(ef.flux_mean[0]), float(ej.flux_mean[0])
        assert abs(mf - mj) < 4.0 * max(sf, sj), (mf, mj, sf, sj)
        assert 0.65 < sf / sj < 1.55, (sf, sj)
        du_f, du_j = np.asarray(ef.du_mean), np.asarray(ej.du_mean)
        tol = 4.0 * float(np.maximum(ef.du_std, ej.du_std).max())
        assert np.hypot(*(du_f - du_j)) < max(tol, 0.02), (du_f, du_j, tol)
    for d in art_f["diagnostics"] + art_j["diagnostics"]:
        assert d["rhat_max"] < 1.1 and d["divergence_rate"] < 0.05, d
