"""Noise-aware performance-regression gate (counterpart of
``celeste_tpu/bench/regression.py``) for the port's benchmark,
``python -m celeste_tpu_torch.bench``.

Two facts shape the gate:

- Run-to-run throughput varies: a card's power limit, its neighbours on the
  host and the host's speed move the samplers, which are bound by the
  host's launch rate.  A fixed 10% gate on a single run would either
  false-alarm or be tuned so loose that it catches nothing.
- The kernel/plain throughput *ratio* of one run cancels most of that noise
  (both paths ride the same card and host), so relative regressions of the
  kernel gate tightly.

Scheme: the port's records file (``records.json`` beside this module by
default, never the repository's root ``bench_records.json``, which holds
the JAX package's TPU histories) keeps the last ``HISTORY`` measurements per
(metric, backend), the backend being the card's name
(``torch.cuda.get_device_name()``) so that histories of different cards
never mix.  The reference is the median of the history, and the tolerance
widens to 3x the observed robust relative spread (1.4826 * MAD / median)
when that exceeds the floor.  Ratio metrics (``check_regression_ratio``)
use the fixed floor, since their noise cancels.

Run ``python -m celeste_tpu_torch.bench.regression [--records PATH]
[--update] [bench arguments]`` on the card: it runs the benchmark and gates
its headline and its kernel/plain ratio; ``--update`` appends the fresh
measurements to the history (always: the history needs noise samples, not
just bests).
"""

from __future__ import annotations

import json
import os
import statistics

RECORDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "records.json")
HISTORY = 8
FLOOR_TOLERANCE = 0.10


def _load():
    if not os.path.exists(RECORDS_PATH):
        return {}
    with open(RECORDS_PATH) as fh:
        return json.load(fh)


def _save(records):
    with open(RECORDS_PATH, "w") as fh:
        json.dump(records, fh, indent=1, sort_keys=True)


def _history(records, key):
    """Measurement list for a key (a scalar record reads as a one-element
    history)."""
    v = records.get(key)
    if v is None:
        return []
    return [v] if isinstance(v, (int, float)) else list(v)


def history_len(metric: str, backend: str) -> int:
    """Number of recorded measurements for (metric, backend).  A 3xMAD gate
    on two points or fewer says nothing; callers use this to flag a thin
    history as immature instead of letting it pass as gated."""
    return len(_history(_load(), f"{metric}::{backend}"))


def robust_reference(history):
    """(median, robust relative spread) of a measurement history."""
    med = statistics.median(history)
    if len(history) < 2 or med == 0:
        return med, 0.0
    mad = statistics.median(abs(x - med) for x in history)
    return med, 1.4826 * mad / abs(med)


def check_regression(metric: str, value: float, backend: str,
                     tolerance: float = FLOOR_TOLERANCE, update: bool = False):
    """Returns (ok, reference_value).  ``ok`` is False when ``value`` falls
    more than the noise-aware tolerance below the recorded history median
    (tolerance = max(floor, 3 x observed robust relative spread))."""
    records = _load()
    key = f"{metric}::{backend}"
    hist = _history(records, key)
    ok, ref = True, None
    if hist:
        ref, spread = robust_reference(hist)
        eff_tol = max(tolerance, 3.0 * spread)
        # a value within the floor tolerance of the worst recorded run is
        # noise by definition, never a regression: 3xMAD alone under-covers
        # small histories where one slow run is the lone outlier
        if ref:
            eff_tol = max(eff_tol, (ref - min(hist)) / abs(ref) + tolerance)
        if value < ref * (1.0 - eff_tol):
            ok = False
    if update:
        hist = (hist + [value])[-HISTORY:]
        records[key] = hist
        _save(records)
    return ok, ref


def check_regression_ratio(metric: str, numerator: float, denominator: float,
                           backend: str, tolerance: float = FLOOR_TOLERANCE,
                           update: bool = False):
    """Gate on a same-run throughput RATIO (kernel/plain): the run's noise
    cancels, so the fixed floor tolerance applies directly."""
    if denominator == 0:
        return True, None
    return check_regression(f"{metric}[ratio]", numerator / denominator,
                            backend, tolerance=tolerance, update=update)


def main(argv=None):
    """Run the benchmark and gate its output against the records."""
    import argparse
    import subprocess
    import sys

    global RECORDS_PATH
    ap = argparse.ArgumentParser(description="Gate python -m celeste_tpu_torch.bench against "
                                             "the port's records; other arguments go to the "
                                             "benchmark.")
    ap.add_argument("--records", default=RECORDS_PATH, help="the records file")
    ap.add_argument("--update", action="store_true", help="append this run to the history")
    args, bench_args = ap.parse_known_args(argv)
    RECORDS_PATH = args.records
    out = subprocess.run([sys.executable, "-m", "celeste_tpu_torch.bench", *bench_args],
                         capture_output=True, text=True)
    sys.stderr.write(out.stderr)
    sys.stderr.write(out.stdout)   # the benchmark's line, kept beside the gate's
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise SystemExit(f"the benchmark failed (exit {out.returncode}): "
                         f"{lines[-1] if lines else 'no result line'}")
    rec = json.loads(lines[-1])
    ok, ref = check_regression(rec["metric"], rec["value"], rec["backend"], update=args.update)
    result = {"ok": ok, "value": rec["value"], "recorded_median": ref,
              "backend": rec["backend"], "records": RECORDS_PATH}
    # the implementation-ratio gate (noise-cancelling), kernel over plain
    if rec.get("evals_per_sec_kernel") and rec.get("evals_per_sec_plain"):
        ok_r, ref_r = check_regression_ratio(
            "stamp_evals kernel/plain", rec["evals_per_sec_kernel"],
            rec["evals_per_sec_plain"], rec["backend"], update=args.update)
        result.update(ok_ratio=ok_r, ratio=rec["evals_per_sec_kernel"] /
                      rec["evals_per_sec_plain"], recorded_ratio_median=ref_r)
        ok = ok and ok_r
        result["ok"] = ok
    print(json.dumps(result))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
