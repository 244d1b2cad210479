"""The traced window put down to the program's spans.

The program names the layers of its gradient and sampler step with
``torch.profiler.record_function`` ranges named ``celeste.<name>``
(``celeste_tpu_torch.utils.profiling.span``), recorded by the same profiler
as the device's activity.  :func:`attribute` puts
every device operation (kernel or copy) of a traced window down to one
name:

1. the host operator that launched it: the one whose correlation id is the
   device operation's linked correlation id (the runtime call that launched
   it shares the device operation's own correlation id and links to the
   same operator);
2. a backward operation (under ``autograd::engine::evaluate_function: ...``,
   on autograd's device thread on the card) takes the span of the forward
   operation with the same sequence number on its forward thread;
3. otherwise the innermost ``celeste.`` span around the launch on its thread;
4. otherwise the harness span (``skybench.<name>``) the host was in at the
   launch, as :func:`skybench.trace.summarize` names a gap (the harness's own
   indexing between steps), or ``traced_window``.

Each idle gap of the device is put down to the name of the operation that
ends it: the card waited for that launch.  The last gap, up to the window's
end, keeps the harness span it began in.  The window, the busy time, the
operation count, device time by name and the gaps' lengths are
:func:`skybench.trace.summarize`'s, computed the same way from the same
events, so ``by_span``'s operations sum to ``n_ops`` and its idle seconds to
``window_s - busy_s``.

:func:`traced_split` traces a window of its own after the cell's traced
window (the same ``trace_steps`` steps through the arm's ``traced``), reads
it, logs the split per gradient on standard error and keeps it on the
record for the metric readers.  Where the program opens no ``celeste.``
span, as before it had them, the split names harness spans only and the
readers return None.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

from skybench.trace import PREFIX, WINDOW, TraceSummary

SPAN = "celeste."
BACKWARD = "autograd::engine::evaluate_function: "


@dataclass
class SpanSummary(TraceSummary):
    """:class:`skybench.trace.TraceSummary` with every device operation and
    idle gap put down to a name; ``idle_gaps`` are named so too."""

    by_span: dict = field(default_factory=dict)   # name -> [device s, ops, idle s]
    program: set = field(default_factory=set)      # the names that are program spans
    launched_early: int = 0                        # device ops that start before their launch
    early_s: float = 0.0                           # the most one starts before it
    unlinked: int = 0                              # device ops with no launch in the trace

    def program_share(self) -> float:
        """Share of the window's device operations put down to a program span."""
        inside = sum(self.by_span[k][1] for k in self.program)
        return inside / self.n_ops if self.n_ops else 0.0


def attribute(device, host) -> SpanSummary:
    """The window's summary with its device operations and idle gaps put
    down to spans, from plain event tuples (start and end in ns):

    - ``device``: (start, end, name, correlation id, linked correlation id)
      of each kernel and copy;
    - ``host``: (start, end, name, thread, correlation id, linked correlation
      id, sequence number, forward thread) of each host event: operators and
      ranges (linked id 0, among them the ``skybench.`` and ``celeste.``
      spans) and runtime calls (linked to the operator that made them).
    """
    windows = [h for h in host if h[2] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the trace, found {len(windows)}")
    w0, w1 = windows[0][:2]
    harness = [(a, b, n) for a, b, n, *_ in host if n.startswith(PREFIX) and n != WINDOW]

    def harness_at(t):
        inside = [s for s in harness if s[0] <= t < s[1]]
        return max(inside)[2][len(PREFIX):] if inside else WINDOW[len(PREFIX):]

    # the window's operations, busy time and gaps exactly as summarize has them
    dev = sorted((max(a, w0), min(b, w1), n, corr, link) for a, b, n, corr, link in device
                 if b > w0 and a < w1)
    by_name: dict = {}
    for a, b, n, _, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    busy, gaps, cur0, cur1 = 0, [], None, w0
    for i, (a, b, *_) in enumerate(dev):
        if cur0 is None or a > cur1:
            if cur0 is not None:
                busy += cur1 - cur0
            gaps.append((cur1, a, i))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur0 is not None:
        busy += cur1 - cur0
    gaps.append((cur1, w1, None))

    # each operator's innermost program span and enclosing backward node, by
    # nesting on its own thread
    ops = [h for h in host if h[5] == 0]
    span_of: list = [None] * len(ops)
    node_of: list = [None] * len(ops)
    threads = defaultdict(list)
    for i, h in enumerate(ops):
        threads[h[3]].append(i)
    for idx in threads.values():
        idx.sort(key=lambda i: (ops[i][0], -ops[i][1]))
        stack: list = []
        for i in idx:
            _, b, name, _, _, _, seq, fwd = ops[i]
            while stack and ops[stack[-1]][1] < b:
                stack.pop()
            sp, node = (span_of[stack[-1]], node_of[stack[-1]]) if stack else (None, None)
            if name.startswith(SPAN):
                sp = name[len(SPAN):]
            if node is None and name.startswith(BACKWARD) and seq >= 0:
                node = (fwd, seq)
            span_of[i], node_of[i] = sp, node
            stack.append(i)
    forward: dict = {}
    for i, h in enumerate(ops):
        if node_of[i] is None and h[6] >= 0:
            forward.setdefault((h[3], h[6]), span_of[i])
    by_corr: dict = {}
    for idx in threads.values():           # an id two events share: the outer one
        for i in idx:
            by_corr.setdefault(ops[i][4], i)
    runtime = {h[4]: h[0] for h in host if h[5] != 0}

    names, program, early, lead, unlinked = [], set(), 0, 0, 0
    for a, _, _, corr, link in dev:
        i = by_corr.get(link)
        if i is None:
            unlinked += 1
            names.append(harness_at(a))
            continue
        name = (forward.get(node_of[i]) if node_of[i] is not None else None) or span_of[i]
        if name is not None:
            program.add(name)
        names.append(name or harness_at(ops[i][0]))
        ahead = runtime.get(corr, ops[i][0]) - a
        early += ahead > 0
        lead = max(lead, ahead)

    by_span: dict = {}
    for (a, b, *_), name in zip(dev, names):
        row = by_span.setdefault(name, [0.0, 0, 0])
        row[0] += (b - a) * 1e-9
        row[1] += 1
    named = []
    for g0, g1, i in gaps:
        name = names[i] if i is not None else harness_at(g0)
        by_span.setdefault(name, [0.0, 0, 0])[2] += g1 - g0
        if g1 > g0:
            named.append((name, (g1 - g0) * 1e-9))
    for row in by_span.values():
        row[2] *= 1e-9
    named.sort(key=lambda g: -g[1])
    return SpanSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, n_ops=len(dev),
                       device_s_by_name=by_name, idle_gaps=named, by_span=by_span,
                       program=program, launched_early=early, early_s=lead * 1e-9,
                       unlinked=unlinked)


def events(prof):
    """(device, host) tuples of :func:`attribute` from a finished
    ``torch.profiler.profile``: the device operations that
    :func:`skybench.trace.summarize` counts, and every host event."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            host.append((start, start + e.duration_ns(), e.name(), e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id(), e.sequence_nr(),
                         e.fwd_thread_id()))
        elif e.device_type() == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", bool)() \
                and not e.name().startswith(PREFIX):
            device.append((start, start + e.duration_ns(), e.name(), e.correlation_id(),
                           e.linked_correlation_id()))
    return device, host


def log_split(split: SpanSummary, grads: float, out=sys.stderr):
    """One ``# skybench`` line: each name's device operations, device ms and
    idle ms per gradient, most operations first."""
    rows = sorted(split.by_span.items(), key=lambda kv: -kv[1][1])
    per = ", ".join(f"{k} {v[1] / grads:.1f} ops {v[0] * 1e3 / grads:.3f} ms device "
                    f"{v[2] * 1e3 / grads:.3f} ms idle" for k, v in rows)
    print(f"# skybench spans per gradient ({grads:.0f} gradients): {per}", file=out,
          flush=True)


def traced_split(rec):
    """(the span split, its value-and-gradient evaluations) of a traced
    window of the cell's ``trace_steps`` steps, traced and read on the first
    call and kept on the record; None where the run is not traced."""
    if "span_split" in rec.__dict__:
        return rec.span_split
    rec.span_split = None
    if rec.trace is None:
        return None
    from torch.profiler import ProfilerActivity, profile

    from skybench.trace import span

    arm = rec.arm
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("traced_window"):
            grads = arm.traced(int(arm.traffic["trace_steps"]))
            arm.ctx.sync()
    traced = time.perf_counter() - t
    t = time.perf_counter()
    split = attribute(*events(prof))
    del prof
    arm.ctx.log(f"spans traced in {traced:.3f} s, read in {time.perf_counter() - t:.3f} s: "
                f"{split.n_ops} device ops ({sum(v[1] for v in split.by_span.values())} put "
                f"down to a span, {100 * split.program_share():.2f}% to the program's), busy "
                f"{split.busy_s:.6f} of {split.window_s:.6f} s, {split.launched_early} "
                f"started before their launch (by up to {split.early_s * 1e6:.3f} us), "
                f"{split.unlinked} unlinked")
    if grads:
        log_split(split, grads)
    rec.span_split = (split, grads)
    return rec.span_split


def per_grad_ops(rec, name: str):
    """Device operations of the program span ``name`` per gradient."""
    got = traced_split(rec)
    if got is None or name not in got[0].by_span or not got[1]:
        return None
    return got[0].by_span[name][1] / got[1]


def idle_share(rec, name: str):
    """Idle seconds put down to the program span ``name`` over the window,
    in %."""
    got = traced_split(rec)
    if got is None or name not in got[0].by_span or got[0].window_s <= 0:
        return None
    return 100.0 * got[0].by_span[name][2] / got[0].window_s
