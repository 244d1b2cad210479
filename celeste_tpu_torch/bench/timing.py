"""Device time of a short kernel call, free of the host's launch rate.

A wrapper call costs tens of microseconds of Python and ctypes on the host;
a kernel that runs for a few microseconds, timed by CUDA events around a
loop of calls, then measures the host.  :func:`graph_ms` captures the calls
in a CUDA graph and times its replays, so consecutive kernels run back to
back on the card.
"""

from __future__ import annotations

import torch


def graph_ms(fn, reps: int = 20, trials: int = 3) -> float:
    """Best of ``trials`` replays of a CUDA graph of ``reps`` calls of
    ``fn``, in ms per call.  ``fn`` runs once first, outside the graph, on
    the capture's side stream (the kernels build and set their attributes
    there)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best
