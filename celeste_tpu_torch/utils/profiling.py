"""Tracing and timing (counterpart of ``celeste_tpu/utils/profiling.py``).

``trace_context`` wraps a block in a ``torch.profiler`` trace (CPU, and the
card's kernels where CUDA is present), written as a Chrome trace that
Perfetto reads; ``timed`` is the synchronised timing harness; ``span``
names a layer of the hot path in the trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

SPAN_PREFIX = "celeste."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``celeste.<name>``
    while a profiler is recording, else one shared no-op context.  The
    profiler records the ranges beside the device's activity, and the
    device operations they launch carry their ids; a span changes no value
    and synchronises nothing.
    The hot path's spans:

    - ``sampler.step``: one jittered-HMC step of a ChEES ensemble
      (``inference.chees._ensemble_step``);
    - ``sampler.grad``: one value and gradient (``inference.hmc.value_and_grad``),
      its forward call and ``torch.autograd.grad``;
    - ``whiten.to_x``: the z -> x map of ``inference.whiten.whiten_logdensity``;
    - ``posterior.planes``: every band's plane preparation, one call of
      ``kernels.scene_planes.ScenePlanes``, and ``posterior.likelihood``: one
      band's tiled likelihood call, in
      ``parallel.crowded.make_tiled_crowded_logdensity``;
    - ``posterior.prior``: the priors and log-Jacobians of every source
      (``parallel.crowded._crowded_logprior``; in the tiled log density on
      the card, ``kernels.scene_prior.ScenePrior``'s kernel pair).

    Backward operations run outside these ranges (on autograd's device
    thread on the card); a reader puts them down to the span of the forward
    operation with the same sequence number.
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace_context(logdir: str | None = None):
    """Profile the enclosed block; yields the profiler and writes its Chrome
    trace to ``logdir/trace.json`` (default: a directory under the system's
    temporary directory).  The trace shows the hot path's :func:`span`
    ranges: ``celeste.sampler.step``, ``celeste.sampler.grad``,
    ``celeste.whiten.to_x``, ``celeste.posterior.planes``,
    ``celeste.posterior.likelihood`` and ``celeste.posterior.prior``."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "celeste_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _device_of(out):
    """The device of the first tensor in ``out`` (a tensor or a nest of them)."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (list, tuple)):
        for o in out:
            d = _device_of(o)
            if d is not None:
                return d
    if isinstance(out, dict):
        return _device_of(list(out.values()))
    return None


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Time ``fn(*args)``: ``warmup`` calls, then ``iters`` timed calls.  On
    the card (the output's device) the time comes from CUDA events around
    the calls, read after a synchronise; on the CPU from
    ``time.perf_counter``.  Returns (seconds per call, last output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    device = _device_of(out) if out is not None else None
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out
