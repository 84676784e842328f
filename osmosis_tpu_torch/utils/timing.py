"""Device timing on a CUDA card, for chip_smoke.py and the port's benchmarks.

* ``graph_time_ms``: device time of one call. ``calls`` calls are captured
  back to back in one CUDA graph, which is replayed; the time is divided by
  the calls. A graph of a single small kernel replays no faster than the host
  can launch it (a few microseconds), so one call per graph would time the
  host; several calls per graph leave the device's own time.
* ``cuda_time_ms``: time per call of back-to-back eager calls, by CUDA events:
  where the host launches slower than the card runs, the host's time.
"""

import time


def graph_time_ms(fn, calls=10, replays=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def cuda_time_ms(fn, iters=None):
    import torch

    fn()
    torch.cuda.synchronize()
    if iters is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = int(min(50, max(3, 0.05 / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
