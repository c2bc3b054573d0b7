"""Timing of work on the card, in ms per call, with CUDA events.

- :func:`event_time_ms` — many calls issued from Python back to back: the
  device time, or the host's time per call where that is longer.
- :func:`graph_time_ms` — the calls captured in one CUDA graph and
  replayed: the device time alone, the wrapper's Python having run once,
  at capture.  The function must launch on the current stream.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def event_time_ms(fn: Callable[[], object], min_total_s: float = 0.2,
                  min_iters: int = 5, max_iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(max_iters, max(min_iters, min_total_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn: Callable[[], object], calls: int = 50,
                  min_total_s: float = 0.2) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    reps = int(max(3, min(200, min_total_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)
