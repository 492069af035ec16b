"""``perfbench/program_spans.py``: its readers on a synthetic Chrome trace
whose values are known by hand; the harness's readers give the same values
on the same trace with and without the program's spans nested inside its
own; and a tiny traced run on the CPU reads the engine's timings and spans
beside the harness's readings."""

import json
import subprocess
import sys
import types

import pytest

from perfbench import program_spans as ps
from perfbench import run, spec
from perfbench import trace as trace_lib
from perfbench.tests import tiny

WINDOW = (0.0, 1000.0)
HARNESS = [(100.0, 300.0, "eager decode step"), (510.0, 700.0, "prefill step"), (820.0, 900.0, "burst")]
PROGRAM = [
    (90.0, 400.0, "engine.decode"), (300.0, 380.0, "engine.sample"), (380.0, 400.0, "engine.emit"),
    (450.0, 460.0, "engine.admit"),
    (500.0, 800.0, "engine.prefill"), (700.0, 790.0, "engine.sample"),
    (810.0, 950.0, "engine.burst"), (830.0, 880.0, "backend.replay"), (880.0, 890.0, "backend.fetch"),
]
# (name, category, start, end, launched at, launch call)
DEVICE = [
    ("void qa::(anonymous namespace)::attn_kernel<64>(CUtensorMap)", "kernel", 120.0, 200.0, 110.0,
     "cudaLaunchKernelExC"),
    ("void (anonymous namespace)::qgemm_wgmma_kernel<128, false, true>(Params)", "kernel", 250.0, 350.0,
     240.0, "cuLaunchKernelEx"),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 385.0, 395.0, 384.0, "cudaMemcpyAsync"),
    ("void qa::k1::flash_fwd_kernel<128, 2, 0>(Params)", "kernel", 600.0, 700.0, 520.0, "cudaLaunchKernel"),
    ("void (anonymous namespace)::tail_gemm_kernel<64, false>(Params)", "kernel", 840.0, 870.0, 835.0,
     "cudaGraphLaunch"),
]


def _events(program: bool):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace_lib.WINDOW_SPAN, "ts": WINDOW[0],
           "dur": WINDOW[1] - WINDOW[0]}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for a, b, n in HARNESS + (PROGRAM if program else [])]
    for i, (name, cat, t0, t1, launched, call) in enumerate(DEVICE):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": call, "ts": launched, "dur": 1.0,
                   "args": {"correlation": i}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 386.0, "dur": 5.0,
               "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 245.0, "dur": 2.0})
    return ev


def _write(tmp_path, program: bool) -> str:
    path = tmp_path / ("with.json" if program else "without.json")
    path.write_text(json.dumps({"traceEvents": _events(program)}))
    return str(path)


def _busy():
    return trace_lib._union((t0, t1) for _, _, t0, t1, _, _ in DEVICE)


def test_readers_on_a_known_trace(tmp_path):
    spans = ps.ProgramSpans.read(_write(tmp_path, True), WINDOW)
    assert spans.innermost(50.0) == ps.OUTSIDE and spans.innermost(300.0) == "engine.sample"
    assert spans.innermost(395.0) == "engine.emit" and spans.innermost(790.0) == "engine.prefill"
    assert spans.innermost(860.0) == "backend.replay" and spans.innermost(805.0) == ps.OUTSIDE
    idle = spans.idle_by_span(_busy())
    # The gaps [0,120) [200,250) [350,385) [395,600) [700,840) [870,1000), by where each began.
    assert idle == pytest.approx({ps.OUTSIDE: 120e-6, "engine.decode": 50e-6, "engine.sample": 35e-6 + 140e-6,
                                  "engine.emit": 205e-6, "backend.replay": 130e-6})
    total_busy = 80 + 100 + 10 + 100 + 30
    assert sum(idle.values()) == pytest.approx((1000 - total_busy) * 1e-6)
    # engine.decode holds the launches at 110, 240 and 384; its 310 us of
    # wall hold 190 us of device work.
    assert spans.launches_per_span("engine.decode") == 3.0
    assert spans.idle_share("engine.decode", _busy()) == pytest.approx(1 - 190 / 310)
    assert spans.launches_per_span("engine.prefill") == 1.0
    assert spans.launches_per_span("engine.nothing") is None
    assert spans.count("engine.sample") == 2 and len(spans.launches) == 5
    assert spans.launched_ops("engine.decode") == {"attn_kernel": 1.0, "qgemm_wgmma_kernel": 1.0,
                                                   "Memcpy DtoH (Device -> Pinned)": 1.0}
    assert spans.launched_ops("engine.burst") == {"tail_gemm_kernel": 1.0}

    timings = {"queue_wait_s": 3.0, "queued_requests": 4, "queue_wait_decode_s": 0.6, "eager_steps": 8,
               "eager_step_s": 0.24, "eager_step_enqueue_s": 0.2, "prefill_s": 1.0, "burst_s": 2.0}
    got = ps.readings(timings, spans, _busy())
    assert got == pytest.approx({"queue_wait_ms": 750.0, "queue_wait_decode_pct": 20.0, "eager_step_ms": 30.0,
                                 "eager_step_launches": 3.0,
                                 "eager_step_idle_pct": 100.0 * (1 - 190 / 310)})


def test_a_program_without_spans_or_timings_reads_nothing(tmp_path):
    spans = ps.ProgramSpans.read(_write(tmp_path, False), WINDOW)
    assert spans.spans == [] and ps.readings(None, None, _busy()) == {}
    assert ps.readings({}, spans, _busy()) == {}
    assert spans.idle_by_span(_busy()) == pytest.approx({ps.OUTSIDE: (1000 - 320) * 1e-6})


def _ctx(tr):
    cfg = spec.program_config(tiny.model())
    calls = [{"kind": "prefill", "host_s": 0.2, "prompt_lens": [60, 60]},
             {"kind": "decode", "steps": [[61, 61]]},
             {"kind": "burst", "host_s": 0.1, "steps": [[62, 62], [63, 63]]}]
    from perfbench.drivers import serve

    return types.SimpleNamespace(cfg=cfg, cell=tiny.cell(), counters={"decode_steps": 3, "graph_replays": 2},
                                 calls=calls, trace=tr, DECODE_SPANS=serve.DECODE_SPANS,
                                 PREFILL_SPANS=serve.PREFILL_SPANS)


@pytest.mark.parametrize("metric", sorted(p.stem for p in (spec.HERE / "metrics").glob("*.py")))
def test_harness_readers_unchanged_by_program_spans(tmp_path, metric):
    from perfbench.drivers import serve

    labels = serve.DECODE_SPANS + serve.PREFILL_SPANS
    without = trace_lib.Trace(_write(tmp_path, False), labels)
    within = trace_lib.Trace(_write(tmp_path, True), labels)
    assert within.ops == without.ops and within.breakdown() == without.breakdown()
    assert within.busy_s == without.busy_s and within.window_s == without.window_s
    for t in (50.0, 150.0, 305.0, 600.0, 850.0):
        assert within.label_at(t) == without.label_at(t)
    names = [trace_lib.kernel_base(d[0]) for d in DEVICE]
    assert within.device_seconds(names, labels) == without.device_seconds(names, labels) > 0
    reader = run.reader(metric)
    a, b = reader.read(_ctx(within)), reader.read(_ctx(without))
    assert a == b


def test_the_script_starts_and_wants_a_card():
    """Run as the chip runs it, from the checkout's root: without a card it
    refuses with exit code 2 and no result line."""
    out = subprocess.run([sys.executable, "perfbench/program_spans.py", "--workload", "mistral-7b.decode-waves",
                          "--seed", "1", "--seconds", "1"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == "", out.stderr[-2000:]
    assert "needs a CUDA card" in out.stderr


def test_tiny_run_reads_timings_and_spans():
    cell = tiny.cell()
    with tiny.kernels_forced():
        res = ps.measure(cell, spec.program_config(cell["model"]), 2**31 + 77, 0.5, 0.0, device="cpu",
                         bench=tiny.BENCH)
        untraced = ps.measure(cell, spec.program_config(cell["model"]), 2**31 + 78, 0.2, 0.0, traced=False,
                              device="cpu", bench=tiny.BENCH)
    assert untraced["correct"] is True and "idle_s" not in untraced
    assert set(untraced["readings"]) == {"queue_wait_ms", "queue_wait_decode_pct", "eager_step_ms"}
    assert set(untraced["e2e"]) == {"output_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}
    assert res["correct"] is True and res["waves"] >= 2
    got = res["readings"]
    assert {"queue_wait_ms", "queue_wait_decode_pct", "eager_step_ms"} <= set(got)
    assert got["queue_wait_ms"] > 0 and 0 <= got["queue_wait_decode_pct"] <= 100
    assert got["eager_step_launches"] == 0.0  # no launch call off the card
    assert {"engine.decode", "engine.prefill", "engine.burst", "engine.emit", "backend.fetch"} \
        <= set(res["program_spans"])
    assert res["idle_charged_s"] == pytest.approx(res["idle_s"], rel=1e-6)
    assert "eager_step_ms" in res["traced_wave"] and "eager_step_ms" in res["untraced_waves"]
    assert res["timings"]["queued_requests"] == cell["traffic"]["requests_per_wave"] * res["waves"]
    assert set(res["harness"]) == {m["name"] for m in tiny.BENCH["per_layer"]
                                   if cell["name"] in m["workloads"]}
