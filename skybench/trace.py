"""Host spans and the device trace of a traced window.

Spans are ``torch.profiler.record_function`` ranges named ``skybench.<name>``
(no-ops unless a profiler is recording).  :func:`summarize` reads the
profiler's (CUPTI) events of the span ``skybench.traced_window``: the
device's busy time as the union of its kernels' and copies' intervals, the
idle share ``1 - busy / wall`` (``chip_profile.py``'s arithmetic over a
union rather than a sum), device time by operation name, and each idle gap
named by the innermost harness span the host was in when it began.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PREFIX = "skybench."
WINDOW = PREFIX + "traced_window"


def short_name(name: str) -> str:
    """A device operation's name without its parameter list and namespaces
    in parentheses: ``void tiled_bwd_kernel<false, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:160] or name[:160]


def span(name: str):
    """A named host span in the trace."""
    from torch.profiler import record_function

    return record_function(PREFIX + name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_ops: int
    device_s_by_name: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)        # [(span name, seconds)], longest first

    @property
    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def top_ops(self, n: int = 10):
        """[(short name, device seconds)] of the ``n`` operations that took
        most, instantiations of one kernel summed."""
        by: dict = {}
        for name, sec in self.device_s_by_name.items():
            by[short_name(name)] = by.get(short_name(name), 0.0) + sec
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def device_s(self, substrings) -> float:
        """Device seconds of the operations whose names hold any of
        ``substrings``."""
        return sum(s for n, s in self.device_s_by_name.items()
                   if any(sub in n for sub in substrings))


def _device_events(events):
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation", bool)():
            continue
        if e.name().startswith(PREFIX):
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return out


def summarize(prof) -> TraceSummary:
    """The traced window's summary from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
           if e.device_type() == DeviceType.CPU and e.name().startswith(PREFIX)]
    windows = [c for c in cpu if c[2] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the trace, found {len(windows)}")
    w0, w1, _ = windows[0]
    spans = [c for c in cpu if c[2] != WINDOW]
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in _device_events(events)
                 if b > w0 and a < w1)
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    busy, gaps, cur0, cur1 = 0, [], None, w0
    for a, b, _ in dev:
        if cur0 is None or a > cur1:
            if cur0 is not None:
                busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur0 is not None:
        busy += cur1 - cur0
    gaps.append((cur1, w1))

    def host_span(t):
        inside = [s for s in spans if s[0] <= t < s[1]]
        return max(inside)[2][len(PREFIX):] if inside else "traced_window"

    named = sorted(((host_span(a), (b - a) * 1e-9) for a, b in gaps if b > a),
                   key=lambda g: -g[1])
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, n_ops=len(dev),
                        device_s_by_name=by_name, idle_gaps=named)
