"""The readings the limits of a cell's compared numbers are set from: for
each seed, one run of the cell (set-up, a window of ``--seconds``, the
comparison), the program's numbers, and, on the first ``--control`` seeds,
the control's: the reference put in the program's place at the same states
(float32 state and components, bfloat16 densities, lambda and Poisson
sums; ``check.control_values``).  ``--fault`` plants a fault of
``faults.py`` under the window on every seed; ``--trace 1`` traces the
last ``--traced`` seeds' runs.  One process, one JSON line a seed::

    python -m skybench.calibrate --workload c5_r.chees --seeds 1,2,3 --seconds 10 --control 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from skybench import check, faults
from skybench.run import banned_modules, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skybench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=0, help="seeds that also read the control")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--traced", type=int, default=0, help="last seeds run with --trace 1")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("skybench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        found = {}

        def on_compared(field, inputs, device, ref):
            found["moments"] = dict(check.moment_gaps(inputs, ref), is_share=ref.is_share,
                                    newton_iters=ref.newton_iters)
            if i < args.control:
                t = time.perf_counter()
                ctl = check.control_values(field, inputs, device)
                found["control"] = check.state_readings(inputs, ref.values, ctl)
                found["control_s"] = time.perf_counter() - t

        t = time.perf_counter()
        traced = i >= len(seeds) - args.traced
        with faults.planted(args.fault):
            out = run_cell(args.workload, seed, args.seconds, traced, "cuda",
                           on_compared=on_compared)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault, "traced": traced,
                "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t, **found}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if banned_modules():
        print(f"skybench.calibrate: loaded {banned_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
