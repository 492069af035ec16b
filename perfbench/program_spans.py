"""The program's own spans and timings in a serving cell: what the serving
engine marks (``utils/profiling.span``: ``engine.*`` and ``backend.*``
ranges, which land in the profiler's trace only while it records) and
keeps (``Engine.timings``), read beside the harness's trace.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> --seconds <s> [--trace 0]

runs the cell as ``perfbench/run.py --trace 1`` (or ``--trace 0``) does
(the same set-up, waves, traced second wave, harness spans and check), and
also

- takes each wave's delta of ``Engine.timings`` (the warm-up wave apart,
  and the traced wave apart from the untraced ones: the spans' cost when
  on);
- reads, from the same Chrome trace, the program's spans and the host's
  launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
  ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``) with
  their times, and charges each idle stretch of the device to the
  innermost program span open when it began (:class:`ProgramSpans`);

and prints one JSON line of those readings (:func:`readings`).  It edits
nothing of the harness: it wraps ``drivers/serve.run_wave`` and
``trace.Trace`` in this process only, so the harness's own readers read
what they read in a ``--trace 1`` run.  A run of a program without these
spans or timings reads none of them and says so.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script
    sys.path.insert(0, str(ROOT))

from perfbench import trace as trace_lib  # noqa: E402

PREFIXES = ("engine.", "backend.")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_NAMES = ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
OUTSIDE = "outside any program span"
DECODE = "engine.decode"

Interval = Tuple[float, float]


def _overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class ProgramSpans:
    """The program's spans (properly nested, one host thread) and the
    host's launch calls inside one traced window, times in microseconds on
    the trace's clock."""

    def __init__(self, events: Iterable[dict], window: Interval) -> None:
        w0, w1 = window
        self.window = window
        spans: List[Tuple[float, float, str]] = []
        launches: List[Tuple[float, object]] = []
        self._device: Dict[object, str] = {}  # correlation id -> kernel name, copy or memset
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts = float(e.get("ts", 0.0))
            if cat == "user_annotation" and name.startswith(PREFIXES):
                t0, t1 = max(ts, w0), min(ts + float(e["dur"]), w1)
                if t1 > t0:
                    spans.append((t0, t1, name))
            elif cat in ("cuda_runtime", "cuda_driver") and (
                    name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES):
                if w0 <= ts < w1:
                    launches.append((ts, e.get("args", {}).get("correlation")))
            elif cat in trace_lib.DEVICE_CATS:
                key = trace_lib.kernel_base(name) if cat == "kernel" else name
                self._device[e.get("args", {}).get("correlation")] = key
        spans.sort(key=lambda s: (s[0], -s[1]))
        launches.sort(key=lambda x: x[0])
        self.spans = spans
        self.launches = [t for t, _ in launches]
        self._launch_corr = [c for _, c in launches]
        # The innermost open span after each change point (None: none open).
        points: List[Tuple[float, Optional[str]]] = []
        stack: List[Tuple[float, float, str]] = []
        for s in spans + [(float("inf"), float("inf"), "")]:
            while stack and stack[-1][1] <= s[0]:
                end = stack.pop()[1]
                points.append((end, stack[-1][2] if stack else None))
            stack.append(s)
            points.append((s[0], s[2]))
        self._times = [p[0] for p in points[:-1]]
        self._names = [p[1] for p in points[:-1]]

    @classmethod
    def read(cls, path: str, window: Interval) -> "ProgramSpans":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], window)

    def innermost(self, ts: float) -> str:
        """The innermost program span open at host time ``ts``."""
        i = bisect.bisect_right(self._times, ts) - 1
        name = self._names[i] if i >= 0 else None
        return name or OUTSIDE

    def count(self, name: str) -> int:
        return sum(s[2] == name for s in self.spans)

    def intervals(self, name: str) -> List[Interval]:
        return [(s[0], s[1]) for s in self.spans if s[2] == name]

    def idle_by_span(self, busy: Sequence[Interval]) -> Dict[str, float]:
        """Seconds of each idle stretch of the window (no kernel, copy or
        memset: the complement of ``busy``, sorted and disjoint) charged to
        the innermost program span open when it began; they add up to the
        window's idle time."""
        idle: Dict[str, float] = {}
        prev = self.window[0]
        for a, b in list(busy) + [(self.window[1], self.window[1])]:
            if a > prev:
                name = self.innermost(prev)
                idle[name] = idle.get(name, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        return dict(sorted(idle.items(), key=lambda kv: -kv[1]))

    def launches_per_span(self, name: str) -> Optional[float]:
        """Host launch calls made inside the spans ``name``, per span."""
        spans = self.intervals(name)
        if not spans:
            return None
        n = sum(bisect.bisect_left(self.launches, t1) - bisect.bisect_left(self.launches, t0)
                for t0, t1 in spans)
        return n / len(spans)

    def launched_ops(self, name: str, top: int = 12) -> Dict[str, float]:
        """The device ops launched from inside the spans ``name``, a span,
        by name (a kernel's ``trace.kernel_base``), the ``top`` most frequent."""
        spans = self.intervals(name)
        counts: Dict[str, int] = {}
        for t0, t1 in spans:
            for i in range(bisect.bisect_left(self.launches, t0), bisect.bisect_left(self.launches, t1)):
                op = self._device.get(self._launch_corr[i])
                if op is not None:
                    counts[op] = counts.get(op, 0) + 1
        ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
        return {k: v / len(spans) for k, v in ranked}

    def idle_share(self, name: str, busy: Sequence[Interval]) -> Optional[float]:
        """Share of the spans ``name``'s wall time (they do not nest in one
        another) in which the device ran nothing."""
        spans = self.intervals(name)
        wall = sum(t1 - t0 for t0, t1 in spans)
        if not wall:
            return None
        return 1.0 - _overlap(spans, busy) / wall


def summed(deltas: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in deltas:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def readings(timings: Optional[Dict[str, float]], spans: Optional[ProgramSpans],
             busy: Sequence[Interval]) -> Dict[str, float]:
    """The five per-layer readings these spans and timings feed, each left
    out where its source is missing or empty:

    - ``queue_wait_ms``: ``queue_wait_s / queued_requests`` (engine);
    - ``queue_wait_decode_pct``: ``queue_wait_decode_s / queue_wait_s``;
    - ``eager_step_ms``: ``eager_step_s / eager_steps`` (model step);
    - ``eager_step_launches``: host launch calls inside ``engine.decode``
      spans, per span (model step);
    - ``eager_step_idle_pct``: share of those spans' wall with nothing on
      the device (device).
    """
    out: Dict[str, float] = {}
    t = timings or {}
    if t.get("queued_requests"):
        out["queue_wait_ms"] = 1e3 * t["queue_wait_s"] / t["queued_requests"]
    if t.get("queue_wait_s"):
        out["queue_wait_decode_pct"] = 100.0 * t["queue_wait_decode_s"] / t["queue_wait_s"]
    if t.get("eager_steps"):
        out["eager_step_ms"] = 1e3 * t["eager_step_s"] / t["eager_steps"]
    if spans is not None:
        launches = spans.launches_per_span(DECODE)
        if launches is not None:
            out["eager_step_launches"] = launches
        idle = spans.idle_share(DECODE, busy)
        if idle is not None:
            out["eager_step_idle_pct"] = 100.0 * idle
    return out


def measure(cell: Dict, cfg, seed: int, seconds: float, t_process: float, traced: bool = True,
            device="cuda", bench: Optional[Dict] = None) -> Dict:
    """One run of a serving cell (``drivers/serve.run``, traced as
    ``--trace 1`` runs are, or not) with each wave's timings and, traced,
    the program's spans read beside it; ``e2e`` and ``harness`` hold the
    harness's own readings of the same run."""
    from perfbench import run as run_lib
    from perfbench import spec
    from perfbench.drivers import serve

    waves: List[Dict] = []
    run_wave, make_trace = serve.run_wave, trace_lib.Trace

    def timed_wave(eng, wave, burst):
        before = dict(getattr(eng, "timings", {}))
        out = run_wave(eng, wave, burst)
        after = getattr(eng, "timings", {})
        waves.append({"timings": {k: v - before[k] for k, v in after.items()}})
        return out

    def traced_trace(path, labels):
        tr = make_trace(path, labels)
        tr.program = ProgramSpans.read(path, tr.window)
        return tr

    serve.run_wave, trace_lib.Trace = timed_wave, traced_trace
    try:
        out = serve.run(cell, cfg, seed, seconds, traced, t_process, device=device)
    finally:
        serve.run_wave, trace_lib.Trace = run_wave, make_trace
    window = waves[1:]  # the first wave warms up
    for i, w in enumerate(window):
        w["traced"] = traced and i == out["ctx"].wave
    timings = summed(w["timings"] for w in window)
    res = {"workload": cell["name"], "seed": seed, "traced": traced, "correct": out["correct"],
           "e2e": out["e2e"], "waves": len(window), "timings": timings,
           "readings": readings(timings or None, None, [])}
    if not traced:
        return res
    tr = out["ctx"].trace
    busy = tr.busy_intervals()
    spans = tr.program if tr.program.spans else None
    res.update({
        "readings": readings(timings or None, spans, busy),
        "traced_wave": readings(summed(w["timings"] for w in window if w["traced"]), None, busy),
        "untraced_waves": readings(summed(w["timings"] for w in window if not w["traced"]), None, busy),
        "window_s": tr.window_s,
        "idle_s": tr.window_s - tr.busy_s,
        "idle_by_program_span": spans.idle_by_span(busy) if spans else {},
        "idle_by_harness_span": dict(tr.breakdown()["idle_gaps"]),
        "program_spans": {n: tr.program.count(n) for n in sorted({s[2] for s in tr.program.spans})},
        "launch_calls": len(tr.program.launches),
        "eager_step_ops": tr.program.launched_ops(DECODE),
    })
    if spans:
        res["idle_charged_s"] = sum(res["idle_by_program_span"].values())
    _, layer = run_lib.cell_metrics(bench or spec.benchmark(), cell["name"])
    res["harness"] = {m["name"]: run_lib.reader(m["name"]).read(out["ctx"]) for m in layer}
    return res


def main(argv=None) -> int:
    from perfbench import run as run_lib

    t_process = run_lib.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run_lib.fixed_cache_dirs()
    import torch

    from perfbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"error: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    t = time.perf_counter()
    res = measure(cell, spec.program_config(cell["model"]), args.seed, args.seconds, t_process,
                  traced=bool(args.trace))
    res["device"] = torch.cuda.get_device_name(0)
    res["measure_s"] = time.perf_counter() - t
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
