"""The benchmark's files, found by name.  ``BENCHMARK.json`` is the only
index: each cell's entry names its configuration and traffic mix, each
metric's its unit, layer and what it moves.  Beside it, by those names:
``configs/<config>.json``, ``traffic/<traffic>.json`` (the mix's
parameters, among them the sampler ``arm``), ``workloads/<cell>.json``
(the limits of the cell's compared numbers), ``drivers/<arm>.py`` and
``metrics/<metric>.py`` (its reader).  Adding a cell, a mix, an arm or a
metric is adding its entry and its files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def names(kind: str, suffix: str = ".json", base: Path = HERE) -> list[str]:
    return sorted(p.name[:-len(suffix)] for p in (base / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, base: Path = HERE):
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"skybench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict, base: Path = HERE) -> dict:
    """A cell of ``bench``: its limits, its configuration and its traffic,
    loaded by the names its entry gives."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return {"name": name, "limits": load_json("workloads", name, base)["limits"],
            "config": load_json("configs", entry["config"], base),
            "traffic": load_json("traffic", entry["traffic"], base)}


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The entries of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]
