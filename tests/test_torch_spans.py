"""The serving engine's spans and timings on the CPU (``utils/profiling.
span``, ``Engine.timings``, the ``Request`` timestamps).

- ``span`` is one shared no-op context while no profiler records, and a
  ``record_function`` range while one does.
- A short ``run_to_completion(decode_burst=4)`` on a tiny tree under a CPU
  ``torch.profiler`` writes the documented spans, nested as the engine's
  docstring says, one a forward, eager step or burst; without a profiler
  it enters no ``record_function`` range at all.
- Each request's timestamps are ordered, and ``Engine.timings`` sums what
  the requests and steps record; ``Engine.stats`` keeps the JAX engine's
  keys.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.utils import profiling

CFG = tl.tiny(attention_impl="bf16")
PROMPTS = [[3, 17, 42, 99, 7], [5, 9, 23, 51], [8, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
           [4, 4, 2], [11, 12, 13, 14, 15, 16]]
N_NEW = 9
ENGINE_SPANS = {"engine.admit", "engine.prefill", "engine.decode", "engine.burst", "engine.sample",
                "engine.emit"}
#: Where each span may sit: the innermost engine span around it (None: none).
PARENTS = {
    "engine.admit": {None},
    "engine.prefill": {None},
    "engine.decode": {None},
    "engine.burst": {None},
    "engine.sample": {"engine.prefill", "engine.decode"},
    "engine.emit": {"engine.prefill", "engine.decode", "engine.burst"},
    "backend.fetch": {"engine.burst"},
}


@pytest.fixture(scope="module")
def params():
    return tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


def _serve(params, backend="slots", prompts=PROMPTS, burst=4):
    kw = dict(cache_backend="paged", page_size=64) if backend == "paged" else {}
    eng = Engine(params, CFG, num_slots=2, max_len=128, cache_dtype=torch.int8, **kw)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
    eng.run_to_completion(decode_burst=burst)
    assert all(r.done and len(r.output) == N_NEW for r in reqs)
    return eng, reqs


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith(("engine.", "backend."))),
                  key=lambda s: (s[0], -s[1]))


def _parent(spans, i):
    """The innermost span other than ``spans[i]`` that holds it."""
    t0, t1, _ = spans[i]
    holders = [s for j, s in enumerate(spans) if j != i and s[0] <= t0 and t1 <= s[1]]
    return max(holders, key=lambda s: s[0])[2] if holders else None


def test_span_is_a_shared_no_op_without_a_profiler():
    a, b = profiling.span("engine.a"), profiling.span("engine.b")
    assert a is b
    with a:
        with b:
            pass


def test_span_is_a_record_function_range_while_recording(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("engine.outer"):
            with profiling.span("backend.inner"):
                torch.ones(4).add_(1)
    assert profiling.span("engine.after") is profiling.span("engine.other")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = _spans(tmp_path / "t.json")
    assert [s[2] for s in spans] == ["engine.outer", "backend.inner"]
    assert spans[0][0] <= spans[1][0] and spans[1][1] <= spans[0][1]


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_engine_writes_its_spans_nested(params, backend, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng, _ = _serve(params, backend)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = _spans(tmp_path / "t.json")
    names = [s[2] for s in spans]
    # On the CPU a burst loops its step: no graph to capture or replay.
    assert set(names) == ENGINE_SPANS | {"backend.fetch"}
    for i, (_, _, name) in enumerate(spans):
        assert _parent(spans, i) in PARENTS[name], (name, _parent(spans, i))
    stats, bstats, timings = eng.stats, eng._backend.stats, eng.timings
    assert names.count("engine.prefill") == stats["prefill_forwards"]
    assert names.count("engine.decode") == timings["eager_steps"] > 0
    assert names.count("engine.burst") == names.count("backend.fetch") == bstats["bursts"] > 0
    assert names.count("engine.sample") == stats["prefill_forwards"] + timings["eager_steps"]


def test_no_range_is_entered_without_a_profiler(params, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: entered.append(a))
    eng, _ = _serve(params)
    assert eng._backend.stats["bursts"] > 0 and eng.timings["eager_steps"] > 0
    assert entered == []


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_request_timestamps_and_timings(params, backend):
    eng, reqs = _serve(params, backend)
    for r in reqs:
        assert r.submitted_at <= r.prefill_started_at <= r.first_token_at
    t = eng.timings
    assert t["queued_requests"] == len(reqs)
    assert t["queue_wait_s"] == pytest.approx(sum(r.prefill_started_at - r.submitted_at for r in reqs),
                                              rel=1e-9, abs=1e-12)
    # Three requests wait for a slot behind eager steps; none can wait
    # longer in eager steps than in all.
    assert 0.0 < t["queue_wait_decode_s"] <= t["queue_wait_s"]
    assert 0.0 < t["eager_step_enqueue_s"] <= t["eager_step_s"]
    assert t["prefill_s"] > 0.0 and t["burst_s"] > 0.0
    assert 0 < t["eager_steps"] < eng.stats["decode_steps"]  # the rest ran in bursts
    assert not eng._eager_s_at_submit


def test_queue_wait_in_eager_steps_is_exact(params, monkeypatch):
    """A request submitted alone waits in no eager step; requests waiting
    for a slot wait in exactly the eager steps run between their submission
    and their prefill (recorded here around each step)."""
    eng, _ = _serve(params, prompts=PROMPTS[:1])
    assert eng.timings["queue_wait_decode_s"] == 0.0
    eng = Engine(params, CFG, num_slots=2, max_len=128, cache_dtype=torch.int8)
    steps = []
    decode = eng._decode

    def recorded():
        before = eng.timings["eager_step_s"]
        out = decode()
        steps.append(eng.timings["eager_step_s"] - before)
        return out

    monkeypatch.setattr(eng, "_decode", recorded)
    waited = {}
    group = eng._prefill_advance_group

    def advance():
        fresh = [r for r in reqs if r.prefill_started_at is None]
        so_far = sum(steps)
        out = group()
        waited.update({r.id: so_far for r in fresh if r.prefill_started_at is not None})
        return out

    monkeypatch.setattr(eng, "_prefill_advance_group", advance)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    eng.run_to_completion()
    assert len(waited) == len(reqs) and sum(v > 0 for v in waited.values()) == 3
    assert eng.timings["queue_wait_decode_s"] == pytest.approx(sum(waited.values()), rel=1e-9)
    assert eng.timings["eager_step_s"] == pytest.approx(sum(steps), rel=1e-9)


def test_cancel_while_waiting_drops_its_mark(params):
    eng = Engine(params, CFG, num_slots=1, max_len=128, cache_dtype=torch.int8)
    a, b = eng.submit([1, 2, 3], max_new_tokens=2), eng.submit([4, 5], max_new_tokens=2)
    eng.cancel(b)
    eng.run_to_completion()
    assert a.done and b.done and not b.output and b.prefill_started_at is None
    assert eng.timings["queued_requests"] == 1 and not eng._eager_s_at_submit


def test_stats_keep_the_jax_engines_keys(params):
    je = JEngine(jl.init_params(jax.random.PRNGKey(0), jl.tiny()), jl.tiny(), num_slots=2, max_len=128,
                 cache_dtype=jnp.int8)
    eng, _ = _serve(params)
    assert set(eng.stats) == set(je.stats)
    assert not set(eng.timings) & set(eng.stats)
    assert set(eng._backend.stats) == {"bursts", "graph_captures", "graph_replays", "step_captures",
                                       "step_replays"}
