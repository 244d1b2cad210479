"""The comparison fails what it should, on the CPU at small sizes: the
control (the reference in the program's place, its densities and sums in
bfloat16) fails a cell's limits, and a run of the cell with the timed path
broken underneath (``faults.py``) comes out not correct, once for each
fault a sampling cell can have on one card: a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; an
answer altered where it is produced; a Metropolis test that accepts every
proposal; a momentum never refreshed.  One card has no exchange between
cards to leave out.  The faults of the transitions show only in the
window's draws, so their runs take the tiny field (``_small.tiny``), where
a test's draws are enough to judge."""

import numpy as np
import pytest
import torch

from skybench import catalog, check, faults
from skybench.reference.field import make_field
from skybench.run import run_cell
from skybench.scene import port_logdensity
from skybench.tests._small import SMALL, tiny

CELLS = ["c5_r.chees", "c5_gri.chees"]


def _limits(cell):
    return catalog.cell(cell, catalog.benchmark())["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """States spread over the posterior's scale in z, whitened by draws
    around the truth: the program's own values pass, the control's fail."""
    from celeste_tpu_torch.inference import ensemble_covariance, whiten_logdensity

    c = catalog.cell(cell, catalog.benchmark())
    f = make_field(c["config"], np.random.default_rng(21))
    logd, _, truth = port_logdensity(f, c["config"], "cpu")
    rng = np.random.default_rng(2)
    draws = truth[None, None] + torch.as_tensor(
        0.002 * rng.normal(size=(32, 4, f.dim)), dtype=torch.float32)
    logd_z, _, _ = whiten_logdensity(logd, *ensemble_covariance(draws, ridge=1e-4))
    z = torch.as_tensor(rng.normal(size=(6, f.dim)), dtype=torch.float32).requires_grad_(True)
    lp = logd_z(z)
    (g,) = torch.autograd.grad(lp.sum(), z)
    inputs = {"probe_draws": draws, "ridge": 1e-4, "segment_states": [],
              "final": (z.detach(), lp.detach(), g), "moved": torch.ones(6, dtype=torch.bool)}
    ref, limits = check.Reference(f, inputs, "cpu"), _limits(cell)
    program = check.state_readings(inputs, ref.values)
    assert all(program[k] <= limits[k] for k in program), program
    control = check.state_readings(inputs, ref.values, check.control_values(f, inputs, "cpu"))
    assert any(control[k] > limits[k] for k in control), control


def _run(fault=None, overrides=SMALL):
    with faults.planted(fault):
        return run_cell("c5_r.chees", 2 ** 31 + 11, 0.0, False, "cpu", overrides=overrides)


def test_small_run_states_match_the_reference():
    """The cell's own field at 16 chains: the states' numbers within their
    limits (the draws are too few there for ``moment_gap_sd``'s)."""
    out = _run()
    limits = _limits("c5_r.chees")
    assert all(out["checks"][k]["value"] <= limits[k]
               for k in ("logp_gap_nats", "grad_rel_gap", "stuck_share")), out["checks"]
    assert out["attempted"] == 6 * 16 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "ess_per_s", "grad_evals_per_s"}


def test_sound_tiny_run_is_correct():
    out = _run(overrides=tiny("c5_r.chees"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,number,size", [
    ("unchanged", "stuck_share", (16, 6)),
    ("half_batch", "grad_rel_gap", (16, 6)),
    ("altered", "grad_rel_gap", (16, 6)),
    ("accept_all", "moment_gap_sd", (256, 100)),
    ("stale_momentum", "moment_gap_sd", (256, 100)),
])
def test_broken_timed_path_is_not_correct(fault, number, size):
    out = _run(fault, tiny("c5_r.chees", *size))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]
