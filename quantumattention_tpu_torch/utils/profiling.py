"""Profiling and timing helpers (counterpart of
quantumattention_tpu/utils/profiling.py).

On the CUDA card a time is device time: :func:`do_bench` reads CUDA events
around a run of calls, :func:`chain_bench` replays one CUDA graph of many
calls between events, so the host's per-call work (Python checks, ctypes,
allocation) stays out.  On the CPU both take ``time.perf_counter`` around a
plain loop, which measures PyTorch's CPU kernels and never stands for a
device time.  :func:`trace` records a ``torch.profiler`` trace, and
:func:`span` marks a stretch of the program's host work in it.

Not ported: ``chain_bench``'s ``perturb`` argument, which folds a carry into
one input so that XLA cannot hoist a loop-invariant call out of its scan;
a captured graph replays every call it recorded.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, ContextManager, Iterator, Optional, Sequence, Union

import torch

from . import checks


@contextlib.contextmanager
def trace(log_dir: str = "build/profile") -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the enclosed block (CPU, and
    the CUDA card where there is one) into ``log_dir/trace.json``, a Chrome
    trace.  Yields the profiler: ``key_averages()`` sums its events by
    name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if checks.cuda_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A named range of host time for a profiler's trace: while a
    ``torch.profiler`` records (:func:`trace`, or any other profiler), a
    ``record_function`` range, which lands in the same Chrome trace as the
    card's kernels, on their clock; otherwise one shared no-op context, so
    that a span costs one check when nothing records (an unguarded
    ``record_function`` costs microseconds even then).  No argument string:
    the Chrome trace drops it (torch 2.11 and 2.13, with or without
    ``record_shapes``)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _median(times: Sequence[float]) -> float:
    return sorted(times)[len(times) // 2]


def do_bench(fn: Callable[[], object], iters: int = 10, warmup: int = 2, reps: int = 3,
             device=None) -> float:
    """Median seconds per call of ``fn`` over ``reps`` runs of ``iters``
    calls, after ``warmup`` calls.  On the card (the default) each run is
    timed by CUDA events on the current stream; with ``device="cpu"`` by
    the host's clock."""
    device = checks.default_device(device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) / iters)
    return _median(times)


def chain_bench(fn: Callable[..., object], args: Union[tuple, list], iters: int = 64, reps: int = 3,
                device=None) -> float:
    """Median seconds per call of ``fn(*args)``: on the card, ``iters``
    calls captured in one CUDA graph (after one warm-up call on a side
    stream) and the graph replayed ``reps`` times between CUDA events; with
    ``device="cpu"``, ``iters`` calls in a loop on the host's clock.
    ``args`` is one argument tuple, or a list of tuples that the calls
    cycle through (copies of a large input, so that each call finds it
    cold in the L2 cache)."""
    device = checks.default_device(device)
    arg_sets = args if isinstance(args, list) else [args]

    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    if device.type != "cuda":
        fn(*arg_sets[0])
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) / iters)
        return _median(times)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()  # the first replay uploads the graph
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / 1e3 / iters)
    del graph
    return _median(times)


def attention_tflops(seconds: float, batch: int, heads: int, q_len: int, kv_len: int,
                     head_dim: int, causal: bool = False) -> float:
    """TFLOP/s of an attention call by the reference's FLOP model (its
    tests/test_interface.py:121-126): 4 * B * H * Sq * Skv * D, halved
    when causal."""
    flops = 2 * (2 * batch * heads * q_len * kv_len * head_dim)
    if causal:
        flops //= 2
    return flops / seconds / 1e12
