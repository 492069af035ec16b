"""The device trace of a traced run: ``torch.profiler`` over one steady
stretch of the window, written as a Chrome trace under ``TMPDIR`` and read
back here without the profiler's own post-processing.

The harness labels its calls into the program with ``record_function``
spans.  Each kernel is tied to the span its launch came from
(the launching runtime call shares the kernel's correlation id; a CUDA
graph's kernels share their ``cudaGraphLaunch``'s), and each idle stretch
of the device to the span the host was in when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

#: The harness's host spans; time outside them inside the traced stretch is
#: the engine's own host work (scheduling, sampling, emission).
WINDOW_SPAN = "traced window"
HOST_OTHER = "engine host work"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_base(name: str) -> str:
    """A demangled kernel's function name without namespaces, template
    arguments or parameters ("void qa::(anonymous namespace)::k<128>(...)"
    -> "k")."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_][A-Za-z0-9_]*)\s*[<(]", name)
    return m.group(1) if m else name


@contextlib.contextmanager
def profiled(enabled: bool) -> Iterator[Optional[str]]:
    """Profile the enclosed block into a Chrome trace under ``TMPDIR``;
    yields the path it will be written to (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def _union_seconds(intervals) -> float:
    return sum(b - a for a, b in _union(intervals)) / 1e6


class Trace:
    """Kernels, spans and idle stretches of one exported trace."""

    def __init__(self, path: str, labels: Iterable[str]) -> None:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.events = len(events)
        labels = set(labels)
        self.window = None
        spans: List[Tuple[float, float, str]] = []
        launch_ts: Dict[int, float] = {}
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat == "user_annotation":
                if name == WINDOW_SPAN:
                    self.window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                elif name in labels:
                    spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), name))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = float(e["ts"])
            elif cat in DEVICE_CATS:
                device.append(e)
        if self.window is None:
            raise ValueError(f"{path}: no '{WINDOW_SPAN}' span")
        spans.sort()
        self._spans = spans
        self._starts = [s[0] for s in spans]
        w0, w1 = self.window
        self.ops: List[Tuple[str, float, float, str]] = []
        for e in device:
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if t1 <= w0 or t0 >= w1:
                continue
            launched = launch_ts.get(e.get("args", {}).get("correlation"), t0)
            self.ops.append((e["name"], max(t0, w0), min(t1, w1), self.label_at(launched)))
        self.ops.sort(key=lambda o: o[1])

    def label_at(self, ts: float) -> str:
        """The harness span holding host time ``ts`` (they do not nest)."""
        i = bisect.bisect_right(self._starts, ts) - 1
        if i >= 0 and ts < self._spans[i][1]:
            return self._spans[i][2]
        return HOST_OTHER

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union((t0, t1) for _, t0, t1, _ in self.ops)

    @property
    def busy_s(self) -> float:
        return _union_seconds((t0, t1) for _, t0, t1, _ in self.ops)

    def device_seconds(self, names: Iterable[str], labels: Optional[Iterable[str]] = None) -> float:
        """Device time in which one of the kernels whose function name
        (:func:`kernel_base`) is in ``names``, launched inside one of the
        spans ``labels`` (any span when None), ran: the union of their
        intervals, since a kernel launched early (programmatic dependent
        launch) waits inside its predecessor's time."""
        names = set(names)
        labels = None if labels is None else set(labels)
        return _union_seconds(
            (t0, t1) for name, t0, t1, lab in self.ops
            if kernel_base(name) in names and (labels is None or lab in labels))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time (summed by name) and the idle
        time of the device summed by what the host was doing when each idle
        stretch began."""
        by_name: Dict[str, float] = {}
        for name, t0, t1, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
        idle: Dict[str, float] = {}
        prev = self.window[0]
        for a, b in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if a > prev:
                lab = self.label_at(prev)
                idle[lab] = idle.get(lab, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        rank = lambda d: sorted(([k[:200], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
