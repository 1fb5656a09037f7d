"""Kernel timing on a CUDA card, by CUDA events."""

from __future__ import annotations

import torch


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events,
    after one warm-up call.  At small shapes this is the host's call
    rate, not the card's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """The card's milliseconds per call without the host: CUDA events
    around one replay of a CUDA graph that holds `iters` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
