"""Decode bursts (``SlotsBackend.burst``, ``Engine.run_to_completion(
decode_burst=n)``) on the CPU, where the step runs n times in a loop, on
the fused route (K9's plain version, ``kernel.megastep = "force"``) and the
unfused one (lean decode + K8's plain version, ``kernel.qmlp = "force"``).

- A burst equals n per-step ``decode`` calls token for token: greedy, the
  same device, the same step function, so the traces must be equal.
- Teacher-forced steps of the fused route against the JAX package's fused
  steps (tests/test_megastep.py:164-196): logits within 2e-2 RMSE / std per
  step, the JAX suite's bar for three steps.
- Schedule invariants on each route: emit counts, EOS stops, per-slot
  budgets, lengths, and a slot that ends one row short of max_len.
- The engine with bursts against the JAX engine with bursts at 16 slots on
  a tiny int8 fused tree: first tokens equal (one prefill forward each),
  output lengths and counters equal; the later tokens of an untrained model
  are not compared (near-ties flip under bf16 rounding differences, ROADMAP
  queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu import config as jconfig
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.serving.backends import SlotsBackend as JSlots
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.serving.backends import SlotsBackend
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.serving.sampling import SamplingParams

SHAPES = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
              num_q_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0)
SLOTS = 16
TRACE_BAR = 2e-2
ROUTES = {
    "mega": {"kernel.megastep": "force", "kernel.qmlp": "force"},
    "lean_k8": {"kernel.megastep": False, "kernel.qmlp": "force"},
}


@pytest.fixture(scope="module")
def trees():
    jcfg, tcfg = jl.LlamaConfig(**SHAPES), tl.LlamaConfig(**SHAPES)
    jtree = jq.fuse_projections(jq.init_quantized_params(jax.random.PRNGKey(0), jcfg))
    ttree = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), tcfg, device="cpu")
    return jtree, ttree, jcfg, tcfg


def _cache_state(seed, max_len, lengths):
    """Random int8 cache content (codes, scales) per layer, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (SLOTS, SHAPES["num_kv_heads"], max_len, SHAPES["head_dim"])
    return [
        (rng.integers(-127, 128, shape).astype(np.int8),
         (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32),
         rng.integers(-127, 128, shape).astype(np.int8),
         (rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32))
        for _ in range(SHAPES["num_layers"])
    ], np.asarray(lengths, np.int32)


def _backend(tcfg, max_len, state):
    values, lengths = state
    be = SlotsBackend(tcfg, num_slots=SLOTS, max_len=max_len, device="cpu")
    for c, (kq, ks, vq, vs) in zip(be.caches, values):
        for dst, src in ((c.k, kq), (c.k_scale, ks), (c.v, vq), (c.v_scale, vs)):
            dst.copy_(torch.from_numpy(src))
        c.lengths.copy_(torch.from_numpy(lengths))
    return be


def _jbackend(jcfg, max_len, state):
    values, lengths = state
    be = JSlots(jcfg, num_slots=SLOTS, max_len=max_len, cache_dtype=jnp.int8)
    be.caches = [
        dataclasses.replace(c, k=jnp.asarray(kq), v=jnp.asarray(vq), k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs), lengths=jnp.asarray(lengths))
        for c, (kq, ks, vq, vs) in zip(be.caches, values)
    ]
    return be


@pytest.mark.parametrize("route", list(ROUTES))
def test_burst_equals_per_step_decode(trees, route):
    _, ttree, _, tcfg = trees
    state = _cache_state(1, 64, [5, 37, 0, 1] + [9] * 12)
    tokens = np.arange(SLOTS) * 7 % 256
    active = np.ones(SLOTS, bool)
    active[3] = False  # never active: emits nothing, keeps its length
    n = 5
    with config.patch(ROUTES[route]):
        be = _backend(tcfg, 64, state)
        assert be.route(ttree) == ("mega" if route == "mega" else "unfused")
        packed = be.burst(ttree, tokens, active, np.full(SLOTS, 100, np.int32),
                          np.full(SLOTS, -1, np.int32), None, n, SamplingParams(), False)
        ref_be = _backend(tcfg, 64, state)
        cur, steps = tokens.copy(), []
        for _ in range(n):
            nxt = ref_be.decode(ttree, cur, active).argmax(-1).numpy()
            cur = np.where(active, nxt, cur)
            steps.append(cur)
    assert packed.shape == (2, n, SLOTS) and be.stats["bursts"] == 1
    np.testing.assert_array_equal(packed[0], np.stack(steps))
    np.testing.assert_array_equal(packed[1], np.tile(active.astype(np.int32), (n, 1)))
    for a, b in zip(be.caches, ref_be.caches):
        assert torch.equal(a.lengths, b.lengths) and torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_teacher_forced_steps_match_jax_mega_steps(trees):
    jtree, ttree, jcfg, tcfg = trees
    state = _cache_state(2, 128, [3, 0, 11, 7] + [1] * 12)
    tokens = np.arange(SLOTS, dtype=np.int32)
    active = np.ones(SLOTS, bool)
    be, jbe = _backend(tcfg, 128, state), _jbackend(jcfg, 128, state)
    for _ in range(3):
        with config.patch(ROUTES["mega"]):
            got = be.decode(ttree, tokens, active).numpy()
        with jconfig.patch({"kernel.megastep": "force", "kernel.qmlp": "force"}):
            jbe.caches, want = jbe._decode_step_impl(jtree, jbe.caches, jnp.asarray(tokens),
                                                     jnp.asarray(active))
        want = np.asarray(want)
        assert float(np.sqrt(np.mean((got - want) ** 2)) / np.std(want)) < TRACE_BAR
        # Teacher-forced next tokens: greedy continuations of an untrained
        # model are near-tie flaky.
        tokens = (tokens * 7 + 1) % SHAPES["vocab_size"]
    np.testing.assert_array_equal(be.caches[0].lengths.numpy(), np.asarray(jbe.caches[0].lengths))


@pytest.mark.parametrize("route", list(ROUTES))
def test_burst_schedule_invariants(trees, route):
    _, ttree, _, tcfg = trees
    max_len, n = 64, 4
    base = np.array([5, 37, 0, max_len - 2, 20, 1] + [9] * 10, np.int32)
    state = _cache_state(3, max_len, base)
    active = np.ones(SLOTS, bool)
    active[2] = False
    remaining = np.full(SLOTS, 9, np.int32)
    remaining[3] = 1  # writes its last row, max_len - 2, then stays inactive one row short
    remaining[4] = 2
    eos = np.full(SLOTS, -1, np.int32)
    tokens = np.arange(SLOTS) * 3 % 256
    with config.patch(ROUTES[route]):
        # A first burst finds each slot's second token; it becomes slot 5's EOS.
        probe = _backend(tcfg, max_len, state)
        first = probe.burst(ttree, tokens, active, remaining, eos, None, n, SamplingParams(), False)
        eos[5] = first[0][1, 5]
        be = _backend(tcfg, max_len, state)
        packed = be.burst(ttree, tokens, active, remaining, eos, None, n, SamplingParams(), False)
    toks, emits = packed[0], packed[1].astype(bool)
    np.testing.assert_array_equal(toks[:2], first[0][:2])  # the same state, the same steps
    expect = np.where(active, np.minimum(remaining, n), 0)
    expect[5] = 1 + np.flatnonzero(first[0][:, 5] == eos[5])[0]  # stops on its EOS
    np.testing.assert_array_equal(emits.sum(0), expect)
    for slot in range(SLOTS):
        k = expect[slot]
        assert emits[:k, slot].all() and not emits[k:, slot].any()  # a prefix of the steps
        assert (toks[k:, slot] == (toks[k - 1, slot] if k else tokens[slot])).all()
    lengths = be.caches[0].lengths.numpy()
    np.testing.assert_array_equal(lengths, base + expect)
    assert lengths[3] == max_len - 1
    for c in be.caches:
        np.testing.assert_array_equal(c.lengths.numpy(), lengths)


def test_engine_burst_matches_per_step_engine(trees):
    """On one device the burst is the per-step decode loop: the same
    tokens, logprobs and counters, with an EOS stop mid-burst."""
    _, ttree, _, tcfg = trees
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23], [8, 1, 2, 3, 4, 5, 6, 7, 8]]

    def serve(burst, eos=None):
        with config.patch(ROUTES["mega"]):
            eng = Engine(ttree, tcfg, num_slots=SLOTS, max_len=64)
            reqs = [eng.submit(p, max_new_tokens=9, logprobs=True, eos_id=eos if i == 1 else None)
                    for i, p in enumerate(prompts)]
            eng.run_to_completion(decode_burst=burst)
        return eng, reqs

    ref_eng, ref = serve(None)
    eng, got = serve(4)
    for a, b in zip(ref, got):
        assert b.done and b.output == a.output
        np.testing.assert_allclose(b.logprob_output, a.logprob_output, rtol=0, atol=1e-6)
    assert eng.stats == ref_eng.stats and eng._backend.stats["bursts"] >= 2
    # A group of two prompts, then the third, each with an eager step;
    # then bursts of 4 and 2 steps and a last eager step.
    assert eng._backend.stats["bursts"] == 2 and eng.timings["eager_steps"] == 3
    eos = ref[1].output[4]
    _, stopped = serve(4, eos=eos)
    assert stopped[1].output == ref[1].output[: ref[1].output.index(eos) + 1]
    assert stopped[0].output == ref[0].output


def test_engine_burst_clamps_at_max_len(trees):
    """A request whose prompt and budget fill max_len exactly: bursts are
    clamped so that no slot writes past its rows."""
    _, ttree, _, tcfg = trees
    with config.patch(ROUTES["mega"]):
        eng = Engine(ttree, tcfg, num_slots=SLOTS, max_len=32)
        req = eng.submit(list(range(1, 21)), max_new_tokens=12)
        other = eng.submit([4, 5], max_new_tokens=30)
        eng.run_to_completion(decode_burst=64)
    assert req.done and len(req.output) == 12
    assert other.done and len(other.output) == 30


def test_sampled_burst_runs(trees):
    _, ttree, _, tcfg = trees
    with config.patch(ROUTES["mega"]):
        eng = Engine(ttree, tcfg, num_slots=SLOTS, max_len=64, seed=3)
        sp = SamplingParams(temperature=0.8, top_k=20)
        reqs = [eng.submit([1, 2, 3], max_new_tokens=6, sampling=sp, logprobs=True) for _ in range(2)]
        eng.run_to_completion(decode_burst=4)
    for r in reqs:
        assert len(r.output) == len(r.logprob_output) == 6
        assert all(0 <= t < SHAPES["vocab_size"] for t in r.output)
        assert all(np.isfinite(v) and v <= 1e-6 for v in r.logprob_output)


def test_engine_burst_matches_jax_engine(trees):
    jtree, ttree, jcfg, tcfg = trees
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 17, 3, 30, 9, 12)]
    budgets = [6, 9, 4, 7, 6, 8]
    with jconfig.patch({"kernel.megastep": "force", "kernel.qmlp": "force"}):
        je = JEngine(jtree, jcfg, num_slots=SLOTS, max_len=64, cache_dtype=jnp.int8)
        jr = [je.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
        je.run_to_completion(decode_burst=4)
    with config.patch(ROUTES["mega"]):
        te = Engine(ttree, tcfg, num_slots=SLOTS, max_len=64)
        tr = [te.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
        te.run_to_completion(decode_burst=4)
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == len(a.output) == b.max_new_tokens
        assert b.output[0] == a.output[0]
    for key in ("prefill_tokens", "prefill_forwards", "generated_tokens"):
        assert te.stats[key] == je.stats[key], key
