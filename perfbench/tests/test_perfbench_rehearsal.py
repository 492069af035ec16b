"""A serving cell's loop rehearsed on the CPU at a tiny size, through the
kernels' plain versions on the card's routes (K9 at decode, K8 and K5/K6
elsewhere): the result line is well formed, the times and shares that
only the card can give read "not measured", and the check passes."""

import json

import pytest

from perfbench import run
from perfbench.tests import tiny


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_line(moe, traced):
    cell = tiny.cell(moe)
    with tiny.kernels_forced():
        res = run.execute(cell["name"], 2**31 + 99, 0.5, traced, 0.0, device="cpu",
                          bench=tiny.BENCH, cell=cell)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= cell["traffic"]["requests_per_wave"] * (2 if traced else 1)
    assert line["device"]["platform"] == "cpu" and line["device"]["memory_peak_bytes"] == "not measured"
    metrics = line["metrics"]
    if traced:
        assert set(metrics) <= {"burst_step_pct", "decode_mfu", "k9_roofline", "qmm_decode_roofline",
                                "idle_pct.decode"}
        assert metrics["burst_step_pct"]["value"] == 0.0  # no CUDA graph off the card
        assert metrics["decode_mfu"]["value"] == "not measured"
        assert line["device"]["busy_s"] == "not measured" and line["breakdown"]["device_ops"] == []
    else:
        assert set(metrics) == {"output_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}
        assert all(m["value"] == "not measured" for m in metrics.values())
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("traced", [False, True])
def test_backlog_line(traced):
    """A wave four times the slots: every request ends, and a traced run
    records only the calls of its ``traced_steps`` stretch."""
    from perfbench import spec
    from perfbench.drivers import serve

    cell = tiny.cell(queue=True)
    cfg = spec.program_config(cell["model"])
    with tiny.kernels_forced():
        out = serve.run(cell, cfg, 2**31 + 98, 0.2, traced, 0.0, device="cpu")
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == cell["traffic"]["requests_per_wave"] * (2 if traced else 1)
    if traced:
        a, b = cell["traced_steps"]
        calls = out["ctx"].calls
        steps = sum(len(c["steps"]) for c in calls if c["kind"] != "prefill")
        burst = cell["engine"]["decode_burst"]
        assert b - a <= steps < b - a + burst
        assert {c["kind"] for c in calls} == {"prefill", "decode", "burst"}
        assert out["ctx"].trace.window_s > 0
        # The host-timed readers of both phases find calls in the stretch
        # (the device-timed ones find no kernels off the card).
        assert run.reader("prefill_mfu").read(out["ctx"]) > 0
        assert run.reader("decode_mfu").read(out["ctx"]) > 0
