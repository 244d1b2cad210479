"""The span attribution of ``skybench.spans`` on synthetic profiler events: a
forward pass on the host thread inside the program's spans, its backward on
another thread, harness-only operations, overlapping device operations and
gaps before each; and its agreement with ``skybench.trace.summarize``."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from skybench import catalog, spans
from skybench.trace import summarize


class Ev:
    """A profiler event with the accessors the readers call."""

    def __init__(self, start, end, name, kind="op", tid=1, corr=0, link=0, seq=-1, fwd=0):
        self.a, self.b, self.n, self.kind = start, end, name, kind
        self.tid, self.corr, self.link, self.seq, self.fwd = tid, corr, link, seq, fwd

    def device_type(self):
        return DeviceType.CUDA if self.kind in ("kernel", "gpu_annotation") else DeviceType.CPU

    def is_user_annotation(self):
        return self.kind in ("annotation", "gpu_annotation")

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd


def _ann(a, b, name, corr):
    return Ev(a, b, name, "annotation", corr=corr)


def _rt(a, b, corr, link, tid=1):
    return Ev(a, b, "cudaLaunchKernel", "runtime", tid=tid, corr=corr, link=link)


def _k(a, b, name, corr, link):
    return Ev(a, b, name, "kernel", corr=corr, link=link)


BWD = "autograd::engine::evaluate_function: "

# (device event, the name the rules give it); gaps before each, as listed in
# EXPECTED_IDLE
DEVICE = [
    (_k(-50, 5, "early", 999, 0), "traced_window"),               # no launch in the trace
    (_k(70, 90, "mul_kernel", 1001, 10), "posterior.planes"),
    (_k(72, 80, "Memcpy DtoD", 1005, 15), "posterior.planes"),    # overlaps the one before
    (_k(140, 300, "tiled_fwd_kernel", 1002, 11), "posterior.likelihood"),
    (_k(222, 230, "log_kernel", 1006, 12), "posterior.prior"),    # on another stream
    (_k(305, 310, "sum_kernel", 1007, 13), "sampler.grad"),
    (_k(312, 315, "fill_kernel", 1008, 32), "sampler.grad"),       # SumBackward0 -> aten::sum
    (_k(320, 500, "tiled_bwd_kernel", 1003, 34), "posterior.likelihood"),
    (_k(505, 510, "div_kernel", 1009, 37), "posterior.prior"),     # LogBackward0 -> aten::log
    (_k(520, 530, "mul_kernel", 1004, 40), "posterior.planes"),    # MulBackward0 -> aten::mul
    (_k(540, 545, "add_kernel", 1011, 42), "sampler_step"),        # AccumulateGrad: no sequence
    (_k(900, 950, "index_kernel", 1010, 20), "sampler_step"),      # the harness's own indexing
]
EXPECTED_IDLE = {"posterior.planes": 65 + 10, "posterior.likelihood": 50 + 5,
                 "sampler.grad": 5 + 2, "posterior.prior": 5, "sampler_step": 10 + 355,
                 "traced_window": 0 + 50}
IGNORED = [
    _k(1100, 1200, "after_the_window", 1012, 20),
    Ev(100, 900, "celeste.posterior.planes", "gpu_annotation"),
    Ev(0, 1000, "skybench.traced_window", "kernel"),
]
HOST = [
    _ann(0, 1000, "skybench.traced_window", 1),
    _ann(10, 900, "skybench.sampler_step", 2),
    _ann(20, 880, "celeste.sampler.step", 3),
    _ann(30, 600, "celeste.sampler.grad", 4),
    _ann(35, 240, "skybench.logdensity", 5),
    _ann(40, 100, "celeste.posterior.planes", 6),
    Ev(50, 60, "aten::mul", corr=10, seq=5), _rt(52, 55, 1001, 10, tid=77),
    Ev(53, 58, "Activity Buffer Request", corr=10),   # a profiler event that shares the id
    Ev(62, 70, "aten::copy_", corr=15), _rt(64, 66, 1005, 15, tid=77),
    _ann(110, 200, "celeste.posterior.likelihood", 7),
    Ev(120, 190, "_TiledKernel", corr=11, seq=6), _rt(130, 135, 1002, 11, tid=77),
    _ann(205, 235, "celeste.posterior.prior", 8),
    Ev(210, 220, "aten::log", corr=12, seq=7), _rt(212, 214, 1006, 12, tid=77),
    Ev(245, 250, "aten::sum", corr=13, seq=8), _rt(246, 247, 1007, 13, tid=77),
    Ev(885, 895, "aten::index", corr=20), _rt(886, 887, 1010, 20, tid=77),
    # autograd's device thread
    Ev(250, 258, BWD + "SumBackward0", tid=2, corr=30, seq=8, fwd=1),
    Ev(251, 257, "SumBackward0", tid=2, corr=31, seq=8, fwd=1),
    Ev(252, 256, "aten::fill_", tid=2, corr=32), _rt(253, 254, 1008, 32, tid=78),
    Ev(260, 400, BWD + "_TiledKernelBackward", tid=2, corr=33, seq=6, fwd=1),
    Ev(261, 399, "_TiledKernelBackward", tid=2, corr=34, seq=6, fwd=1),
    _rt(262, 264, 1003, 34, tid=78),
    Ev(405, 415, BWD + "LogBackward0", tid=2, corr=35, seq=7, fwd=1),
    Ev(406, 414, "LogBackward0", tid=2, corr=36, seq=7, fwd=1),
    Ev(407, 413, "aten::div", tid=2, corr=37), _rt(408, 409, 1009, 37, tid=78),
    Ev(420, 450, BWD + "MulBackward0", tid=2, corr=38, seq=5, fwd=1),
    Ev(421, 449, "MulBackward0", tid=2, corr=39, seq=5, fwd=1),
    Ev(425, 430, "aten::mul", tid=2, corr=40), _rt(426, 427, 1004, 40, tid=78),
    Ev(455, 460, BWD + "torch::autograd::AccumulateGrad", tid=2, corr=41),
    Ev(456, 459, "aten::add_", tid=2, corr=42), _rt(457, 458, 1011, 42, tid=78),
]
PROGRAM = {"posterior.planes", "posterior.likelihood", "posterior.prior", "sampler.grad"}


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(evs))))


def _split(evs):
    return spans.attribute(*spans.events(_prof(evs)))


def _all():
    # interleaved as a profiler hands them over, not sorted
    return HOST[::2] + [d for d, _ in DEVICE] + IGNORED + HOST[1::2]


def test_each_op_and_gap_gets_the_span_the_rules_give():
    split = _split(_all())
    want: dict = {}
    for d, name in DEVICE:
        a, b = max(d.a, 0), min(d.b, 1000)
        row = want.setdefault(name, [0.0, 0, 0.0])
        row[0] += (b - a) * 1e-9
        row[1] += 1
    for name, ns in EXPECTED_IDLE.items():
        want[name][2] = ns * 1e-9
    assert set(split.by_span) == set(want)
    for name, (dev_s, ops, idle_s) in want.items():
        assert split.by_span[name][1] == ops, name
        assert split.by_span[name][0] == pytest.approx(dev_s, rel=1e-12, abs=0), name
        assert split.by_span[name][2] == pytest.approx(idle_s, rel=1e-12, abs=1e-18), name
    assert split.program == PROGRAM
    assert split.program_share() == 9 / 12
    assert split.launched_early == 0 and split.early_s == 0.0 and split.unlinked == 1
    # longest first; gaps of one length in the order of time
    assert split.idle_gaps[:4] == [("sampler_step", pytest.approx(355e-9)),
                                   ("posterior.planes", pytest.approx(65e-9)),
                                   ("posterior.likelihood", pytest.approx(50e-9)),
                                   ("traced_window", pytest.approx(50e-9))]


def test_counts_and_idle_seconds_sum_to_the_window():
    split = _split(_all())
    assert sum(v[1] for v in split.by_span.values()) == split.n_ops == len(DEVICE)
    idle = sum(v[2] for v in split.by_span.values())
    assert idle == pytest.approx(split.window_s - split.busy_s, rel=1e-12)
    assert split.busy_s == pytest.approx(443e-9, rel=1e-12)


def test_existing_summary_fields_are_unchanged():
    """window_s, busy_s, n_ops, device_s_by_name, idle_share, top_ops and
    the gaps' lengths are bit for bit summarize's on the same events."""
    evs = _all()
    old, new = summarize(_prof(evs)), _split(evs)
    assert (new.window_s, new.busy_s, new.n_ops) == (old.window_s, old.busy_s, old.n_ops)
    assert new.device_s_by_name == old.device_s_by_name
    assert new.idle_share == old.idle_share
    assert new.top_ops() == old.top_ops()
    assert new.device_s(("tiled_",)) == old.device_s(("tiled_",))
    assert [g[1] for g in new.idle_gaps] == [g[1] for g in old.idle_gaps]


def test_an_op_that_starts_before_its_launch_is_counted():
    evs = _all()
    evs[evs.index(DEVICE[1][0])] = _k(51, 90, "mul_kernel", 1001, 10)   # its runtime call: 52
    split = _split(evs)
    assert split.launched_early == 1 and split.early_s == pytest.approx(1e-9)


def test_a_program_without_spans_gives_no_program_metric():
    """The parent's program opens no celeste. span: every operation falls to
    the harness's names and the readers return None."""
    evs = [e for e in _all() if not e.n.startswith("celeste.")]
    split = _split(evs)
    assert split.program == set() and split.program_share() == 0.0
    assert sum(v[1] for v in split.by_span.values()) == split.n_ops
    rec = SimpleNamespace(trace=object(), span_split=(split, 4.0))
    for name in ("posterior.planes_ops_per_grad", "posterior.prior_ops_per_grad",
                 "posterior.planes_idle_share", "posterior.prior_idle_share"):
        assert catalog.load_module("metrics", name).read(rec) is None


def test_the_metric_readers_read_the_split():
    split = _split(_all())
    rec = SimpleNamespace(trace=object(), span_split=(split, 4.0))
    read = {name: catalog.load_module("metrics", name).read(rec)
            for name in ("posterior.planes_ops_per_grad", "posterior.prior_ops_per_grad",
                         "posterior.planes_idle_share", "posterior.prior_idle_share")}
    assert read["posterior.planes_ops_per_grad"] == 3 / 4
    assert read["posterior.prior_ops_per_grad"] == 2 / 4
    assert read["posterior.planes_idle_share"] == pytest.approx(100 * 75e-9 / 1000e-9)
    assert read["posterior.prior_idle_share"] == pytest.approx(100 * 5e-9 / 1000e-9)


def test_an_untraced_run_traces_nothing():
    class Arm:
        def traced(self, steps):
            raise AssertionError("an untraced run traced a window")

    rec = SimpleNamespace(trace=None, arm=Arm())
    assert spans.traced_split(rec) is None
    assert spans.per_grad_ops(rec, "posterior.planes") is None


def test_the_stderr_line_lists_every_span_per_gradient(capsys):
    import sys

    spans.log_split(_split(_all()), 2.0, out=sys.stdout)
    line = capsys.readouterr().out.strip()
    assert line.startswith("# skybench spans per gradient (2 gradients): ")
    assert "posterior.planes 1.5 ops " in line and line.count(" ms idle") == 6
