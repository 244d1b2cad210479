"""The harness's own checks: what it imports, that a cell, a traffic mix, a
configuration, an arm or a metric is added by adding a file, that
``BENCHMARK.json`` keeps to the contract's names and units, and that the
command refuses to run without a CUDA card."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from skybench import catalog

HERE = catalog.HERE
ROOT = catalog.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path):
    """The top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = set(_imports(path)) & {"jax", "jaxlib", "flax", "celeste_tpu"}
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        tops = set(_imports(path))
        assert "celeste_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "dataclasses", "numpy", "torch", "skybench"}, \
            (path, tops)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("skybench."):
                assert node.module.startswith("skybench.reference."), (path, node.module)


def test_top_level_name_match_is_whole():
    """celeste_tpu_torch begins with celeste_tpu: the check compares whole
    top-level names."""
    from skybench.run import BANNED, banned_modules

    assert "celeste_tpu" in BANNED
    before = dict(sys.modules)
    try:
        sys.modules["celeste_tpu_torch_probe"] = sys
        assert "celeste_tpu" not in banned_modules()
        sys.modules["celeste_tpu.bench"] = sys
        assert "celeste_tpu" in banned_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_files_dropped_in_are_found_without_a_code_edit(tmp_path):
    """A new cell is its entry in BENCHMARK.json and its files: limits,
    configuration, traffic, arm and metric reader, each found by name."""
    from skybench import check

    base = tmp_path / "skybench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    bench = catalog.benchmark()
    bench["workloads"].append({"name": "c5_r.chees2", "config": "c5_r2", "traffic": "chees8",
                               "chips": 1, "why": "a dropped-in cell"})
    bench["per_layer"].append({"name": "window.steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "sampler",
                               "moves": "ess_per_s", "workloads": ["c5_r.chees2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "workloads" / "c5_r.chees2.json").write_text(json.dumps(
        {"limits": {k: 1.0 for k in check.NUMBERS}}))
    cfg = json.loads((base / "configs" / "c5_r.json").read_text())
    (base / "configs" / "c5_r2.json").write_text(json.dumps(dict(cfg, name="c5_r2")))
    traffic = json.loads((base / "traffic" / "chees64k.json").read_text())
    (base / "traffic" / "chees8.json").write_text(json.dumps(dict(traffic, chains=8,
                                                                  arm="chees2")))
    shutil.copy(base / "drivers" / "chees.py", base / "drivers" / "chees2.py")
    (base / "metrics" / "window.steps.py").write_text(
        '"""The window\'s steps."""\n\n\ndef read(rec):\n    return rec.window["steps"]\n')
    bench = catalog.benchmark(tmp_path)
    assert "c5_r.chees2" in catalog.names("workloads", base=base)
    cell = catalog.cell("c5_r.chees2", bench, base=base)
    assert cell["config"]["name"] == "c5_r2" and cell["traffic"]["chains"] == 8
    assert cell["limits"] == {k: 1.0 for k in check.NUMBERS}
    assert hasattr(catalog.load_module("drivers", cell["traffic"]["arm"], base=base), "Arm")

    class Rec:
        window = {"steps": 7}

    assert catalog.load_module("metrics", "window.steps", base=base).read(Rec) == 7
    assert "window.steps" in [m["name"] for m in catalog.metrics_for(bench, "c5_r.chees2",
                                                                      "per_layer")]
    assert "window.steps" not in [m["name"] for m in catalog.metrics_for(bench, "c5_r.chees",
                                                                          "per_layer")]


def test_benchmark_json_keeps_to_the_contract():
    from skybench import check

    bench = catalog.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["skybench"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in metrics:
        assert callable(catalog.load_module("metrics", m["name"]).read), m["name"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("skybench/")
        for key in c["reduced"]:
            assert NAME.match(key)
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in configs and NAME.match(w["traffic"])
        cell = catalog.cell(w["name"], bench)
        assert set(cell["limits"]) == set(check.NUMBERS)
        assert hasattr(catalog.load_module("drivers", cell["traffic"]["arm"]), "Arm")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("where", ["checkout", "benchmark_only"])
def test_cli_exits_nonzero_without_cuda(tmp_path, where):
    """No CUDA card: a non-zero exit and no result line; also in a directory
    that holds only BENCHMARK.json and the benchmark's files."""
    cwd = ROOT
    if where == "benchmark_only":
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
        shutil.copytree(HERE, cwd / "skybench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "skybench", "--workload", "c5_r.chees",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
