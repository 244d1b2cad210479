"""The port's benchmark entry on the CPU: ``bench/regression.py`` against the
JAX package's on the same histories (and the counterparts of
tests/test_checkpoint_experiments.py's regression tests), every stage of
``bench/stages.py`` at a small size on the CPU (a few chains and steps
through the stage's arguments; its keys present and finite), and
``python -m celeste_tpu_torch.bench``'s one JSON line and exit codes.
The numbers here are CPU numbers and are never read as the card's.
"""

import functools
import json
import math
import os
import tempfile

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import celeste_tpu.bench.regression as jreg

import celeste_tpu_torch.bench.regression as reg
from celeste_tpu_torch.bench import __main__ as bench_main
from celeste_tpu_torch.bench import config5 as c5
from celeste_tpu_torch.bench import stages

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"
# each stage at a small size, and the keys of BENCH_r05.json it must return
SMALL = {
    "evals": (dict(n=64, iters=2, trials=1, loop_k=2),
              ("evals_per_sec_kernel", "evals_per_sec_plain", "evals_per_sec_device_loop",
               "value", "vs_baseline")),
    "config5_tiled": (dict(n_chains=4, n_warmup=2, warmup_window=2, n_zwarm=2, probe_steps=2,
                           chees_warmup_iters=2, chees_steps=4, chees_segment=2, nuts_steps=4,
                           nuts_segment=2),
                      ("tiled_dense_parity", "tiled_dense_parity_rel", "ess_per_sec_tiled_chees",
                       "ess_vs_oracle_config5_chees", "ess_per_sec_tiled",
                       "tiled_divergence_frac", "ess_vs_oracle_config5")),
    "crowded_ess": (dict(n_chains=8, n_warmup=4, n_steps=8, chees_warmup_iters=4,
                         max_leapfrog=8),
                    ("ess_per_sec_crowded", "ess_vs_oracle", "ess_per_sec_crowded_chees",
                     "ess_vs_oracle_chees")),
    "photoz_batch": (dict(n_targets=4, n_steps=4, n_warmup=2, segment_steps=2),
                     ("photoz_targets_per_sec", "photoz_vs_oracle",
                      "photoz_targets_per_sec_steady", "photoz_vs_oracle_steady",
                      "photoz_z_recovery_frac", "photoz_batch_n")),
    "tiled_field": (dict(n_chains=4, calls=2), ("tiled_field_evals_per_sec",)),
    "config5_multiband": (dict(n_chains=4, n_warmup=2, warmup_window=2, n_zwarm=2,
                               probe_steps=2, chees_warmup_iters=2, chees_steps=4,
                               chees_segment=2),
                          ("tiled_multiband_parity", "tiled_multiband_parity_rel",
                           "ess_per_sec_tiled_multiband_chees")),
    "pipeline": (dict(n_chains=4, n_warmup=4, n_steps=8, map_steps=10, type_switch_steps=4),
                 ("pipeline_wall_time_s",)),
}


# ---------------------------------------------------------------------------
# the regression gate
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(hist=st.lists(st.floats(1.0, 1e6), min_size=0, max_size=8),
       value=st.floats(1.0, 1e6), update=st.booleans())
def test_check_regression_matches_jax(hist, value, update):
    """On the same history (0-8 measurements), each package in its own
    records file: the same (ok, reference), the same ratio gate, and, with
    ``update``, the same history written."""
    with tempfile.TemporaryDirectory() as d:
        paths = {"port": os.path.join(d, "port.json"), "jax": os.path.join(d, "jax.json")}
        for p in paths.values():
            with open(p, "w") as fh:
                json.dump({"m::card": hist, "m[ratio]::card": hist}, fh)
        old = reg.RECORDS_PATH, jreg.RECORDS_PATH
        reg.RECORDS_PATH, jreg.RECORDS_PATH = paths["port"], paths["jax"]
        try:
            got = reg.check_regression("m", value, "card", update=update)
            want = jreg.check_regression("m", value, "card", update=update)
            assert got == want
            got = reg.check_regression_ratio("m", value, 2.0, "card", update=update)
            want = jreg.check_regression_ratio("m", value, 2.0, "card", update=update)
            assert got == want
            assert reg.history_len("m", "card") == jreg.history_len("m", "card")
        finally:
            reg.RECORDS_PATH, jreg.RECORDS_PATH = old
        with open(paths["port"]) as a, open(paths["jax"]) as b:
            assert json.load(a) == json.load(b)


def test_regression_gate(tmp_path, monkeypatch):
    monkeypatch.setattr(reg, "RECORDS_PATH", str(tmp_path / "records.json"))
    ok, ref = reg.check_regression("m", 100.0, "cpu", update=True)
    assert ok and ref is None
    ok, ref = reg.check_regression("m", 95.0, "cpu")
    assert ok and ref == 100.0
    ok, _ = reg.check_regression("m", 80.0, "cpu")
    assert not ok


def test_regression_gate_noise_aware(tmp_path, monkeypatch):
    """With a history showing +-25% run-to-run noise another noisy run
    passes, a genuine large regression trips the gate, and the history is
    bounded."""
    path = str(tmp_path / "records.json")
    monkeypatch.setattr(reg, "RECORDS_PATH", path)
    for v in (100.0, 75.0, 125.0, 95.0):
        reg.check_regression("tput", v, "card", update=True)
    ok, ref = reg.check_regression("tput", 70.0, "card")
    assert ok, (ok, ref)
    ok, _ = reg.check_regression("tput", 35.0, "card")
    assert not ok
    for v in [90.0] * 12:
        reg.check_regression("tput", v, "card", update=True)
    with open(path) as fh:
        assert len(json.load(fh)["tput::card"]) == reg.HISTORY


def test_regression_gate_outlier_history_invariant(tmp_path, monkeypatch):
    """A value no worse than one already recorded (or within the floor of
    it) passes, though 3xMAD alone would flag it; a genuine 2x loss does
    not."""
    monkeypatch.setattr(reg, "RECORDS_PATH", str(tmp_path / "records.json"))
    for v in (337645.0, 328185.0, 242335.0):
        reg.check_regression("chees", v, "card", update=True)
    assert reg.check_regression("chees", 250000.0, "card")[0]
    assert reg.check_regression("chees", 242335.0, "card")[0]
    assert reg.check_regression("chees", 236454.0, "card")[0]
    assert not reg.check_regression("chees", 160000.0, "card")[0]


def test_regression_gate_ratio_and_scalar_record(tmp_path, monkeypatch):
    path = str(tmp_path / "records.json")
    monkeypatch.setattr(reg, "RECORDS_PATH", path)
    with open(path, "w") as fh:
        json.dump({"old::card": 200.0}, fh)
    ok, ref = reg.check_regression("old", 150.0, "card")
    assert not ok and ref == 200.0
    assert reg.check_regression_ratio("r", 1.0, 0.0, "card") == (True, None)
    reg.check_regression_ratio("r", 3.0, 2.0, "card", update=True)
    with open(path) as fh:
        assert json.load(fh)["r[ratio]::card"] == [1.5]


def test_regression_main_writes_the_cards_history(tmp_path, monkeypatch, capsys):
    """``main --update --records PATH`` runs the benchmark (its subprocess
    replaced here by a recorded line), gates its headline and kernel/plain
    ratio, and appends both under the card's name to PATH, which is the
    port's own file, never the root ``bench_records.json``."""
    import subprocess

    line = {"metric": "single-stamp likelihood evals/sec/chip", "value": 3.0e8,
            "evals_per_sec_kernel": 2.0e8, "evals_per_sec_plain": 1.0e7,
            "backend": "NVIDIA H100 80GB HBM3", "stages_failed": []}
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(line) + "\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(reg, "RECORDS_PATH", reg.RECORDS_PATH)
    records = tmp_path / "records.json"
    reg.main(["--update", "--records", str(records), "--stages", "evals"])
    assert calls[0][1:] == ["-m", "celeste_tpu_torch.bench", "--stages", "evals"]
    got = json.loads(records.read_text())
    assert got == {f"{line['metric']}::{line['backend']}": [3.0e8],
                   f"stamp_evals kernel/plain[ratio]::{line['backend']}": [20.0]}
    assert json.loads(capsys.readouterr().out.strip())["ok"]
    assert os.path.dirname(reg.__file__) != os.path.dirname(jreg.RECORDS_PATH)


# ---------------------------------------------------------------------------
# the stages and the entry
# ---------------------------------------------------------------------------

@pytest.fixture
def caches(tmp_path, monkeypatch):
    """The config-5 warm-start caches in a temporary directory."""
    monkeypatch.setattr(c5, "prep_cache_path", lambda name: str(tmp_path / f"{name}_prep.npz"))


@pytest.mark.parametrize("name", list(SMALL))
def test_stage_at_a_small_size_on_the_cpu(name, caches):
    kwargs, keys = SMALL[name]
    out = stages.STAGES[name](CPU, **kwargs)
    for key in keys:
        assert key in out, key
        assert math.isfinite(float(out[key])), (key, out[key])


def test_stages_run_in_bench_py_order():
    assert list(stages.STAGES) == ["evals", "config5_tiled", "crowded_ess", "photoz_batch",
                                   "tiled_field", "config5_multiband", "pipeline"]


def test_main_prints_exactly_one_json_line(monkeypatch, capsys):
    monkeypatch.setitem(stages.STAGES, "evals",
                        functools.partial(stages.evals, **SMALL["evals"][0]))
    assert bench_main.main(["--device", "cpu", "--stages", "evals"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["backend"] == "cpu" and rec["stages_failed"] == []
    assert set(rec["stage_walls_s"]) == {"evals"} and rec["value"] > 0
    assert "evals/sec" in err


def test_main_names_a_failed_stage_and_exits_1(monkeypatch, capsys):
    def broken(device):
        raise ValueError("no such scene")

    monkeypatch.setitem(stages.STAGES, "tiled_field", broken)
    monkeypatch.setitem(stages.STAGES, "evals",
                        functools.partial(stages.evals, **SMALL["evals"][0]))
    assert bench_main.main(["--device", "cpu", "--stages", "tiled_field,evals"]) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["stages_failed"] == [{"stage": "tiled_field",
                                     "error": "ValueError: no such scene"}]
    assert list(rec["stage_walls_s"]) == ["evals", "tiled_field"] and rec["value"] > 0


def test_main_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        bench_main.main(["--stages", "evals"])
