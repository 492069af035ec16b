"""The single decode step's CUDA graph (``serving/backends._run_step``) on
the CPU, where it never engages, and its key rule under a stand-in graph.

- On the CPU the step stays eager on both backends: ``step_captures`` and
  ``step_replays`` exist and stay 0, no step state is kept, and the engine
  keeps the JAX engine's schedule (its counters) and each request's solo
  tokens while eager steps run between prefill forwards.
- The decision: graphs on a CUDA device without a mesh, never on the CPU
  or under a mesh (a gloo collective cannot be captured).
- The key rule, with ``torch.cuda``'s graph replaced by a stand-in whose
  capture runs its body once and whose replay launches nothing: a key's
  first call is eager, its second captures and replays, later calls
  replay; a new params tree, a new route or a new setting of the config
  flags gets its own graph; every graph of a backend shares one memory
  pool; replays credit the launch counters an eager step moves; the
  returned logits are a copy; the paged allocator's bookkeeping runs
  outside the graph on every call; no cyclic collection runs inside a
  capture, and the collector's state is restored.
"""

import contextlib
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert, quantized
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import megastep
from quantumattention_tpu_torch.serving import backends
from quantumattention_tpu_torch.serving.engine import Engine

CFG = tl.tiny(attention_impl="bf16")
PROMPTS = [[3, 17, 42, 99, 7], [5, 9, 23, 51], [8, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 4, 2]]
N_NEW = 5
#: K9's shapes (head dim 128, slots in sixteens) at a tiny width.
FUSED = tl.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
                       num_q_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0)
SLOTS = 16
STEP_KEYS = {"step_captures", "step_replays"}


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _engine(params, backend, num_slots):
    kw = dict(cache_backend="paged", page_size=32) if backend == "paged" else {}
    return Engine(params, CFG, num_slots=num_slots, max_len=128, cache_dtype=torch.bfloat16, **kw)


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_cpu_steps_stay_eager(params, jax_params, backend):
    """Two slots and four prompts: eager steps run between prefill forwards,
    none of them through a graph; the counters are the JAX engine's and each
    request's tokens its solo run's."""
    eng = _engine(params, backend, 2)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    eng.run_to_completion()
    be = eng._backend
    assert STEP_KEYS <= set(be.stats) and all(be.stats[k] == 0 for k in STEP_KEYS)
    assert be.stats["graph_captures"] == be.stats["graph_replays"] == 0 and not be._steps
    assert eng.timings["eager_steps"] == eng.stats["decode_steps"] > len(PROMPTS)
    je = JEngine(jax_params, jl.tiny(attention_impl="bf16"), num_slots=2, max_len=128,
                 cache_dtype=jnp.bfloat16)
    for p in PROMPTS:
        je.submit(p, max_new_tokens=N_NEW)
    je.run_to_completion()
    for key in ("prefill_tokens", "prefill_forwards", "decode_steps", "generated_tokens"):
        assert eng.stats[key] == je.stats[key], key
    for req, prompt in zip(reqs, PROMPTS):
        solo = _engine(params, backend, 1)
        sr = solo.submit(prompt, max_new_tokens=N_NEW)
        solo.run_to_completion()
        assert req.done and req.output == sr.output


@pytest.mark.parametrize("device,mesh,graphs", [
    ("cpu", False, False), ("cpu", True, False), ("cuda", False, True), ("cuda", True, False),
])
def test_graph_decision(device, mesh, graphs):
    """Graphs exactly where bursts take them: the device and the mesh decide."""
    be = types.SimpleNamespace(device=torch.device(device), tp=object() if mesh else None)
    assert backends._graphs(be) is graphs


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the capture (the stand-in
    ``torch.cuda.graph``) runs its body once, which is that call's step; a
    replay launches nothing."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on for CPU backends, with the stand-in graph; records each
    capture's pool and each pool handle made."""
    seen = types.SimpleNamespace(pools=[], handles=[], collecting=[])

    @contextlib.contextmanager
    def capture(graph, pool=None):
        seen.pools.append(pool)
        seen.collecting.append(gc.isenabled())
        yield

    def handle():
        seen.handles.append(object())
        return seen.handles[-1]

    monkeypatch.setattr(backends, "_graphs", lambda backend: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", handle)
    return seen


def _fused_tree(seed):
    return quantized.fuse_projections(quantized.init_quantized_params(torch.Generator().manual_seed(seed), FUSED))


def _slots():
    return backends.SlotsBackend(FUSED, num_slots=SLOTS, max_len=64, device="cpu")


def test_each_params_tree_gets_its_own_graph(stand_in, monkeypatch):
    plain = megastep.fused_decode_layer_plain

    def counted(*args, **kw):  # K9's count, as the kernel's launch moves it
        megastep.fused_decode_layer.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(megastep, "fused_decode_layer_plain", counted)
    a, b = _fused_tree(1), _fused_tree(2)
    be = _slots()
    toks, ones = np.arange(SLOTS) % FUSED.vocab_size, np.ones(SLOTS, bool)
    with config.patch({"kernel.megastep": "force", "kernel.qmlp": "force"}):
        before = megastep.fused_decode_layer.launches
        outs = [be.decode(tree, toks, ones) for tree in (a, a, a, b, b, a)]
        assert megastep.fused_decode_layer.launches - before == 6 * FUSED.num_layers
    steps = {key[:2]: state for key, state in be._steps.items()}
    assert len(steps) == len(be._steps) and set(steps) == {(id(a), "mega"), (id(b), "mega")}
    assert steps[(id(a), "mega")].params is a and steps[(id(b), "mega")].params is b
    # a: eager, capture + replay, replay, replay; b: eager, capture + replay.
    assert be.stats == {"bursts": 0, "graph_captures": 0, "graph_replays": 0,
                        "step_captures": 2, "step_replays": 4}
    assert len(stand_in.handles) == 1 and stand_in.pools == stand_in.handles * 2
    assert outs[1] is not steps[(id(a), "mega")].logits
    assert outs[1].shape == (SLOTS, FUSED.vocab_size) and outs[1].dtype == torch.float32


def test_each_route_gets_its_own_graph(stand_in):
    tree = _fused_tree(1)
    be = _slots()
    toks, ones = np.arange(SLOTS) % FUSED.vocab_size, np.ones(SLOTS, bool)
    for flag in ("force", False, "force", False):
        with config.patch({"kernel.megastep": flag, "kernel.qmlp": "force"}):
            be.decode(tree, toks, ones)
    assert {key[:2] for key in be._steps} == {(id(tree), "mega"), (id(tree), "unfused")}
    assert len(be._steps) == 2
    assert be.stats["step_captures"] == 2 and be.stats["step_replays"] == 2


def test_each_flag_setting_gets_its_own_graph(stand_in, monkeypatch):
    """A flag the traced step reads is part of the key: after ``kernel.qmlp``
    changes, the step (same tree, same route) runs and captures anew under
    the new flag instead of replaying the graph captured under the old one,
    and the old setting's graph replays again once the flag is back."""
    from quantumattention_tpu_torch.ops import qmlp

    plain, calls = qmlp.fused_layer_tail_plain, []

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(qmlp, "fused_layer_tail_plain", counted)
    tree = _fused_tree(1)
    be = _slots()
    toks, ones = np.arange(SLOTS) % FUSED.vocab_size, np.ones(SLOTS, bool)
    ran = []
    for flag, n in (("force", 3), (False, 2), ("force", 1)):
        with config.patch({"kernel.megastep": False, "kernel.qmlp": flag}):
            assert be.route(tree) == "unfused"
            for _ in range(n):
                before = len(calls)
                be.decode(tree, toks, ones)
                ran.append(len(calls) - before)
    # force: eager, capture + replay, replay; off: eager, capture + replay
    # (no K8); force again: a replay of the first graph.
    assert ran == [FUSED.num_layers, FUSED.num_layers, 0, 0, 0, 0]
    keys = set()
    for flag in ("force", False):
        with config.patch({"kernel.megastep": False, "kernel.qmlp": flag}):
            keys.add((id(tree), "unfused", config.snapshot()))
    assert len(keys) == 2 and set(be._steps) == keys
    assert be.stats["step_captures"] == 2 and be.stats["step_replays"] == 4


def test_burst_and_step_graphs_share_a_pool_and_keep_their_counters(stand_in):
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    tree = _fused_tree(1)
    be = _slots()
    toks, ones = np.arange(SLOTS) % FUSED.vocab_size, np.ones(SLOTS, bool)
    with config.patch({"kernel.megastep": "force", "kernel.qmlp": "force"}):
        be.burst(tree, toks, ones, np.full(SLOTS, 9, np.int32), np.full(SLOTS, -1, np.int32), None, 4,
                 SamplingParams(), False)
        for _ in range(3):
            be.decode(tree, toks, ones)
    assert be.stats == {"bursts": 1, "graph_captures": 1, "graph_replays": 3,
                        "step_captures": 1, "step_replays": 2}
    assert len(stand_in.handles) == 1 and stand_in.pools == stand_in.handles * 2


def test_paged_allocator_runs_outside_the_graph(stand_in, params):
    """Every call reserves and advances the host lengths, replayed or not."""
    be = backends.PagedBackend(CFG, num_slots=2, max_len=128, page_size=32, cache_dtype=torch.bfloat16,
                               device="cpu")
    for slot in range(2):
        be.alloc.allocate(slot, 8, 32)
        be.alloc.lengths[slot] = 3
    mask = np.array([True, False])
    for _ in range(4):
        logits = be.decode(params, np.array([5, 0]), mask)
    assert logits.shape == (2, CFG.vocab_size)
    np.testing.assert_array_equal(be.host_lengths(), [7, 3])
    assert be.stats["step_captures"] == 1 and be.stats["step_replays"] == 3
    assert [key[:2] for key in be._steps] == [(id(params), "paged")]


@pytest.mark.parametrize("was_on", [True, False])
def test_no_collection_inside_a_capture(stand_in, was_on):
    """A collection inside a capture could destroy a dead backend's graphs
    there; the collector is off for the capture and as it was after."""
    tree = _fused_tree(1)
    be = _slots()
    toks, ones = np.arange(SLOTS) % FUSED.vocab_size, np.ones(SLOTS, bool)
    (gc.enable if was_on else gc.disable)()
    try:
        with config.patch({"kernel.megastep": "force", "kernel.qmlp": "force"}):
            for _ in range(3):
                be.decode(tree, toks, ones)
        assert gc.isenabled() is was_on
    finally:
        gc.enable()
    assert stand_in.collecting == [False] and be.stats["step_captures"] == 1
