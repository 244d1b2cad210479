"""CLI entry point: ``python -m celeste_tpu_torch.run config=<name> key=value ...``
(counterpart of ``celeste_tpu/run.py``).  See ``celeste_tpu_torch.experiments``
for the configs and the override syntax."""

from __future__ import annotations

import copy
import sys

from celeste_tpu_torch.experiments import CONFIGS, parse_overrides, run_experiment


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    name = "star_single"
    for a in argv:
        if a.startswith("config="):
            name = a.split("=", 1)[1]
    if name not in CONFIGS:
        raise SystemExit(f"config {name!r} is unknown or not yet ported to "
                         f"celeste_tpu_torch; available: {sorted(CONFIGS)} "
                         f"(ROADMAP.md lists the configs still to port)")
    cfg = parse_overrides(copy.deepcopy(CONFIGS[name]), argv)
    return run_experiment(cfg)


if __name__ == "__main__":
    main()
