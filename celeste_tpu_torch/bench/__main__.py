"""The port's benchmark entry (counterpart of ``bench.py``'s stages):

    python -m celeste_tpu_torch.bench [--stages a,b] [--device cuda|cpu]

runs the stages of ``bench/stages.py`` in ``bench.py``'s order (all of
them, or the ones named) and prints exactly one JSON line on stdout, under
``BENCH_r05.json``'s keys where their meaning carries over, with
``stage_walls_s``, ``backend`` (the card's name, or ``cpu``) and
``stages_failed``; everything else goes to stderr.  A stage that raises is
named in ``stages_failed`` with its error, the later stages still run, and
the process exits 1 after printing the line.  It runs on the card unless
``--device cpu`` is given, and raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import torch


def run(stage_names, device) -> dict:
    """Run the named stages on ``device`` in order; the result record."""
    from celeste_tpu_torch.bench.stages import STAGES

    result = {"stage_walls_s": {}, "stages_failed": []}
    t0 = time.perf_counter()
    for name in stage_names:
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                result.update(STAGES[name](device))
        except Exception as e:  # noqa: BLE001 -- each stage's failure is reported, not hidden
            traceback.print_exc(file=sys.stderr)
            result["stages_failed"].append({"stage": name, "error": f"{type(e).__name__}: {e}"})
        result["stage_walls_s"][name] = time.perf_counter() - t
        print(f"# stage {name}: {result['stage_walls_s'][name]:.3f} s", file=sys.stderr,
              flush=True)
    result["bench_wall_s"] = time.perf_counter() - t0
    result["backend"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else device.type)
    return result


def main(argv=None) -> int:
    from celeste_tpu_torch.bench.stages import STAGES
    from celeste_tpu_torch.experiments import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"comma-separated stages, run in this order: {','.join(STAGES)}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = [s for s in names if s not in STAGES]
    if unknown:
        ap.error(f"unknown stages {unknown}; the stages are {list(STAGES)}")
    device = resolve_device(args.device)
    result = run([s for s in STAGES if s in names], device)
    print(json.dumps(result), flush=True)
    return 1 if result["stages_failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
