"""The port's spans (``celeste_tpu_torch.utils.profiling.span``) on the
config-5 crowded field in r (12 blended sources, 48 x 128, the tiled
likelihood's plain path on the CPU) at 4 chains: the six spans of a ChEES
step and their nesting, the backward put down to the forward's spans by
sequence number, the shared no-op without a profiler, and the same samples
bit for bit inside and outside a profiler."""

import contextlib
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from celeste_tpu_torch.bench.config5 import build_config5
from celeste_tpu_torch.inference import chees
from celeste_tpu_torch.inference.hmc import value_and_grad
from celeste_tpu_torch.inference.whiten import whiten_logdensity
from celeste_tpu_torch.utils import span

SPANS = ("sampler.step", "sampler.grad", "whiten.to_x", "posterior.planes",
         "posterior.likelihood", "posterior.prior")
BACKWARD = "autograd::engine::evaluate_function: "


@pytest.fixture(scope="module")
def field():
    logd, _, vec, _ = build_config5(device="cpu")
    d = vec.shape[0]
    logd_z, _, _ = whiten_logdensity(logd, vec, 1e-5 * torch.eye(d))
    z = 0.3 * torch.randn(4, d, generator=torch.Generator().manual_seed(1))
    logp, grad = value_and_grad(logd_z, z)
    return logd_z, chees.ChEESState(z, logp, grad)


def _step(logd_z, state, n_steps=1, max_leapfrog=1, seed=2):
    """``n_steps`` ChEES steps; at ``max_leapfrog`` 1 each is one value and
    gradient."""
    gen = torch.Generator().manual_seed(seed)
    return chees.run_chees_ensemble(gen, logd_z, state, n_steps=n_steps, step_size=0.2,
                                    trajectory_length=0.6, max_leapfrog=max_leapfrog)


def _host_events(prof):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id(),
             e.sequence_nr(), e.fwd_thread_id())
            for e in prof.profiler.kineto_results.events()]


def _innermost_span(events, ev):
    """The innermost ``celeste.`` span around ``ev`` on its thread."""
    around = [e for e in events if e[2].startswith("celeste.") and e[3] == ev[3]
              and e[0] <= ev[0] and ev[1] <= e[1] and e is not ev]
    return max(around, key=lambda e: e[0])[2][len("celeste."):] if around else None


@pytest.fixture(scope="module")
def one_step(field):
    logd_z, state = field
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(logd_z, state)
    return _host_events(prof)


def test_one_gradient_opens_the_six_spans_nested(one_step):
    got = defaultdict(list)
    for e in one_step:
        if e[2].startswith("celeste."):
            got[e[2][len("celeste."):]].append(e)
    assert sorted(got) == sorted(SPANS)
    assert all(len(v) == 1 for v in got.values()), {k: len(v) for k, v in got.items()}
    s = {k: v[0] for k, v in got.items()}

    def inside(inner, outer):
        return s[outer][0] <= s[inner][0] and s[inner][1] <= s[outer][1]

    assert inside("sampler.grad", "sampler.step")
    for name in ("whiten.to_x", "posterior.planes", "posterior.likelihood", "posterior.prior"):
        assert inside(name, "sampler.grad"), name
        assert _innermost_span(one_step, s[name]) == "sampler.grad", name
    # in the order the log density calls them, none inside another
    order = ["whiten.to_x", "posterior.planes", "posterior.likelihood", "posterior.prior"]
    for a, b in zip(order, order[1:]):
        assert s[a][1] <= s[b][0], (a, b)


def test_backward_ops_lead_to_the_forward_spans(one_step):
    """Each backward node's sequence number names the forward operation that
    made it; the forward operations of the posterior's backward lie inside
    its plane, likelihood and prior spans."""
    forward = {}
    for e in one_step:
        if e[4] >= 0 and not e[2].startswith(BACKWARD) and e[5] == 0:
            forward.setdefault((e[3], e[4]), e)
    nodes = [e for e in one_step if e[2].startswith(BACKWARD) and e[4] >= 0]
    assert len(nodes) > 50
    named = defaultdict(int)
    for node in nodes:
        fwd = forward.get((node[5], node[4]))
        assert fwd is not None, node
        named[_innermost_span(one_step, fwd)] += 1
    assert {"posterior.planes", "posterior.likelihood", "posterior.prior"} <= set(named), named
    # the tiled likelihood is a few autograd nodes, its call a bucket and the sums
    assert named["posterior.likelihood"] < min(named["posterior.planes"],
                                               named["posterior.prior"])


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = span("posterior.planes"), span("sampler.step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("posterior.prior"):
            torch.ones(2).sum()
    assert "celeste.posterior.prior" in [e[2] for e in _host_events(prof)]


def test_profiled_segment_gives_the_same_samples_bitwise(field):
    logd_z, state = field
    plain = _step(logd_z, state, n_steps=2, max_leapfrog=3, seed=5)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _step(logd_z, state, n_steps=2, max_leapfrog=3, seed=5)
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[2], traced[2]):
        assert torch.equal(a, b)


def test_the_prior_kernel_pair_is_put_down_to_the_prior_span(field, monkeypatch):
    """On the card the tiled log density's prior is one forward and one
    backward launch of ``kernels.scene_prior.ScenePrior``'s kernel pair.
    Here the kernel path is taken on the CPU, with the two launches stood in
    for by the plain prior: the pair's forward operation lies inside
    ``celeste.posterior.prior``, and its backward node leads there by
    sequence number, so the launches of both are put down to the span."""
    from celeste_tpu_torch.kernels import scene_prior as sp

    def fwd(prep, vecs):
        fwd.launches += 1
        with torch.no_grad():
            return prep.plain(vecs)

    def bwd(prep, vecs, g):
        bwd.launches += 1
        with torch.enable_grad():
            x = vecs.detach().requires_grad_(True)
            return torch.autograd.grad(prep.plain(x), x, g)[0]

    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(sp, "scene_prior_fwd_cuda", fwd)
    monkeypatch.setattr(sp, "scene_prior_bwd_cuda", bwd)
    monkeypatch.setattr(sp.ScenePrior, "__call__", sp.ScenePrior.launch)
    logd_z, state = field
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(logd_z, state)
    events = _host_events(prof)
    assert (fwd.launches, bwd.launches) == (1, 1)
    kernel = [e for e in events if e[2] == "_ScenePriorKernel"]
    assert len(kernel) == 1 and _innermost_span(events, kernel[0]) == "posterior.prior"
    nodes = [e for e in events if e[2] == BACKWARD + "_ScenePriorKernelBackward"]
    assert len(nodes) == 1 and nodes[0][4] >= 0
    forward = [e for e in events if (e[3], e[4]) == (nodes[0][5], nodes[0][4])
               and not e[2].startswith(BACKWARD) and e[5] == 0]
    assert forward and forward[0][2] == "_ScenePriorKernel"
    assert _innermost_span(events, forward[0]) == "posterior.prior"
