"""One run of one cell of the benchmark of ``celeste_tpu_torch``::

    python -m skybench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

finds the cell's files by name, builds the field from the configuration and
the seed, does the sampler arm's set-up, samples for ``--seconds``, checks
the window's states against the plain reference, and prints one JSON line
as the last line of standard output (the compared numbers beside their
limits also close standard error).  ``--trace 1`` runs a profiled segment
after the window and reports the cell's per-layer metrics instead of its
end-to-end ones.  A run needs as many CUDA cards as the cell names; there
is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import zlib

import numpy as np

from skybench import catalog, check
from skybench.trace import span

BANNED = ("jax", "jaxlib", "flax", "celeste_tpu")


class Streams:
    """Independent random streams derived from the run's seed by name."""

    def __init__(self, seed: int):
        self.seed = int(seed) % (1 << 64)

    def _seq(self, name):
        return np.random.SeedSequence([self.seed, zlib.crc32(name.encode())])

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self._seq(name))

    def torch(self, name: str, device):
        import torch

        lo, hi = self._seq(name).generate_state(2, np.uint32)
        gen = torch.Generator(device=device)
        gen.manual_seed((int(hi) << 32 | int(lo)) >> 1)
        return gen


class Context:
    """What an arm's driver sees: the device, the configuration, the
    traffic, the seed's streams, the program's log density and the true
    state, and the set-up's phases."""

    def __init__(self, device, config, traffic, streams, logd, truth):
        self.device, self.config, self.traffic = device, config, traffic
        self.streams, self.logd, self.truth = streams, logd, truth
        self.phases: dict = {}

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.phases[name] = time.perf_counter() - t0

    @staticmethod
    def log(msg):
        print(f"# skybench {msg}", file=sys.stderr, flush=True)


class Record:
    """Everything a metric reader reads."""

    def __init__(self, **kw):
        self.trace = None
        self.grad_ms = None
        self.__dict__.update(kw)
        self._min_ess = None

    def min_ess(self):
        if self._min_ess is None:
            from skybench.reference.diagnostics import ess

            self._min_ess = float(ess(self.arm.draws_x()).min())
        return self._min_ess


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, overrides: dict | None = None, bench: dict | None = None,
             on_compared=None):
    """One run; returns the result object of the last line (without
    printing it).  ``overrides``: {"config": {...}, "traffic": {...},
    "prep": {...}} merged over the cell's files (tests and sweeps).
    ``on_compared(field, inputs, device, ref)``, where given, is called with
    what the comparison read (the control's readings are taken so)."""
    import torch

    log = Context.log
    t0 = time.perf_counter() if t0 is None else t0
    overrides = overrides or {}
    bench = bench if bench is not None else catalog.benchmark()
    c = catalog.cell(cell_name, bench)
    config = _merge(c["config"], overrides.get("config"))
    config["prep"] = _merge(config["prep"], overrides.get("prep"))
    traffic = _merge(c["traffic"], overrides.get("traffic"))
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from skybench.reference.field import make_field
    from skybench.scene import port_logdensity
    from skybench.work import gradient_work

    streams = Streams(seed)
    field = make_field(config, streams.numpy("counts"))
    logd, _, truth = port_logdensity(field, config, device)
    ctx = Context(device, config, traffic, streams, logd, truth)
    arm = catalog.load_module("drivers", traffic["arm"]).Arm(ctx)
    arm.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items()))
    win = arm.window(seconds)
    log(f"window {win['seconds']:.3f} s: {win['steps']} steps, {win['grad_evals']:.0f} "
        f"gradients of {traffic['chains']} chains, divergence {win['divergence_share']:.5f}")
    rec = Record(arm=arm, setup_s=setup_s, window=win,
                 work=gradient_work(field, int(traffic["chains"])))
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from skybench.trace import summarize

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with span("traced_window"):
                rec.traced_grad_evals = arm.traced(int(traffic["trace_steps"]))
                ctx.sync()
        t = time.perf_counter()
        rec.trace = summarize(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t:.3f} s: {rec.trace.n_ops} device ops, "
            f"busy {rec.trace.busy_s:.6f} of {rec.trace.window_s:.6f} s")
        rec.grad_ms = arm.grad_ms(int(traffic["grad_calls"]))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    kind = "per_layer" if trace else "end_to_end"
    t = time.perf_counter()
    metrics = {}
    for m in catalog.metrics_for(bench, cell_name, kind):
        value = catalog.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"metrics read in {time.perf_counter() - t:.3f} s")
    inputs = arm.check_inputs()
    arm.samples.clear()
    t = time.perf_counter()
    ref = check.Reference(field, inputs, device, int(traffic["moment_samples"]),
                          streams.torch("moments", device))
    values = check.readings(inputs, ref)
    log(f"reference compared in {time.perf_counter() - t:.3f} s: mode in {ref.newton_iters} "
        f"Newton steps, importance weights' effective share {ref.is_share:.4f}")
    if on_compared is not None:
        on_compared(field, inputs, device, ref)
    correct, checks = check.judge(values, c["limits"])
    out = {"correct": correct, "attempted": win["chain_transitions"], "failed": win["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if rec.trace is not None:
        tr = rec.trace
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [[n, s] for n, s in tr.top_ops()],
                            "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
    out["checks"] = checks
    return out


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m skybench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = catalog.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"skybench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"skybench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    Context.log(f"card: {power_limit()}")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0,
                   bench=bench)
    found = banned_modules()
    if found:
        print(f"skybench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, m in out["metrics"].items():
        Context.log(f"metric {name} = {m['value']!r} {m['unit']}")
    print(json.dumps(out), flush=True)
    for name, ch in out["checks"].items():
        print(f"check {name} = {ch['value']!r} (limit {ch['limit']!r})", file=sys.stderr,
              flush=True)
    return 0
