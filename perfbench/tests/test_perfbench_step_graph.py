"""``metrics/step_graph_pct``: the share of the window's eager decode steps
(``decode_steps`` less the burst steps, ``graph_replays``) that replayed
the single step's CUDA graph (``step_replays``), read from the counters
``drivers/serve.py`` hands its readers."""

import types

import torch

from perfbench import run, spec
from perfbench.drivers import serve
from perfbench.traffic import load as load_traffic
from perfbench.tests import tiny

READER = run.reader("step_graph_pct")


def _read(counters):
    return READER.read(types.SimpleNamespace(counters=counters))


def test_step_replays_over_eager_steps():
    assert _read({"decode_steps": 100, "graph_replays": 68, "step_replays": 32}) == 100.0
    assert _read({"decode_steps": 100, "graph_replays": 68, "step_replays": 8, "step_captures": 1}) == 25.0


def test_nothing_to_read():
    """A program without the counter (an earlier version) and a window without
    eager steps read nothing."""
    assert _read({"decode_steps": 100, "graph_replays": 68}) is None
    assert _read({"decode_steps": 64, "graph_replays": 64, "step_replays": 0}) is None
    assert _read({}) is None


def test_cpu_engine_reads_zero():
    """On the CPU every eager step runs uncaptured: a wave's counters, as
    ``drivers/serve.py`` takes them, carry ``step_replays`` at 0 beside
    eager steps."""
    cell = tiny.cell()
    cfg = spec.program_config(cell["model"])
    with tiny.kernels_forced():
        eng = serve.build_engine(cell, cfg, 2**31 + 7, torch.device("cpu"))
        gen = load_traffic(cell["traffic"], cfg.vocab_size, 2**31 + 7)
        before = serve._counters(eng)
        serve.run_wave(eng, gen.wave(0), cell["engine"]["decode_burst"])
    counters = {k: v - before[k] for k, v in serve._counters(eng).items()}
    assert counters["decode_steps"] > counters["graph_replays"] == 0
    assert _read(counters) == 0.0
