"""A Mixtral-style tiny model served by the port's engine, on both
backends, against the JAX engine.

Both engines serve the same tiny MoE model (JAX ``init_params(PRNGKey(0))``
of ``tiny(num_experts=4)``, converted) with an int8 cache.  As for the dense
model (tests/test_torch_engine.py, tests/test_torch_paged_engine.py), the
first tokens and the schedule's counters must be equal and later tokens
are not compared: near-ties of an untrained model may flip under bf16
rounding differences (ROADMAP queue 3, "Nondeterministic CPU runs").  The
MoE FFN must see the rows the JAX engine feeds it, in the same shapes:
expert capacity counts the padded prefill width, the chunk width and every
slot at decode, idle ones included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import moe as jmoe
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch.models import convert, moe
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.models import quantized as tq
from quantumattention_tpu_torch.serving.engine import Engine

JCFG = jl.tiny(num_experts=4, attention_impl="bf16")
CFG = tl.tiny(num_experts=4, attention_impl="bf16")
PROMPTS = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(8, 150))]
SHARED = [(5 * i) % 200 + 1 for i in range(70)]
PAGED_PROMPTS = [SHARED + [9, 8, 7], SHARED + [1], list(range(3, 40)), SHARED + [2, 2]]
PAGED = dict(cache_backend="paged", page_size=32, prefill_chunk=64, prefix_cache=True)
N_NEW = 5


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


def _record(monkeypatch, module):
    """The (rows, width) of every MoE FFN call through ``module.moe_ffn``
    (JAX records at trace time, once per compiled shape)."""
    seen = []
    fn = module.moe_ffn

    def recording(p, x, **kw):
        seen.append(tuple(int(n) for n in x.shape[:-1]))
        return fn(p, x, **kw)

    monkeypatch.setattr(module, "moe_ffn", recording)
    return seen


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_moe_engine_matches_jax_engine(jax_params, params, monkeypatch, backend):
    kw = dict(num_slots=2, max_len=256, **(PAGED if backend == "paged" else {}))
    prompts = PAGED_PROMPTS if backend == "paged" else PROMPTS
    jseen, tseen = _record(monkeypatch, jmoe), _record(monkeypatch, moe)
    je = JEngine(jax_params, JCFG, cache_dtype=jnp.int8, **kw)
    jr = [je.submit(p, max_new_tokens=N_NEW) for p in prompts]
    je.run_to_completion()
    te = Engine(params, CFG, cache_dtype=torch.int8, **kw)
    tr = [te.submit(p, max_new_tokens=N_NEW) for p in prompts]
    te.run_to_completion()
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == N_NEW
        assert b.output[0] == a.output[0]
    keys = ["prefill_tokens", "prefill_forwards", "decode_steps", "generated_tokens"]
    if backend == "paged":
        keys += ["prefix_hits", "prefix_tokens_reused"]
        assert te.stats["prefix_hits"] >= 1
    for key in keys:
        assert te.stats[key] == je.stats[key], key
    # The same FFN row shapes: (group, padded width) or (1, chunk) at
    # prefill, (num_slots, 1) at decode, two layers each.
    assert set(tseen) == set(jseen)
    assert (2, 1) in tseen and all(rows * width >= 2 for rows, width in tseen)
    assert ((1, 64) if backend == "paged" else (1, 256)) in tseen


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_moe_engine_bursts_match_steps(params, backend):
    """Decode bursts of an int8 MoE tree give the per-step run's tokens
    (on the CPU a burst is the same step in a loop)."""
    tree = tq.quantize_params(params)
    kw = dict(num_slots=2, max_len=256, cache_dtype=torch.int8, **(PAGED if backend == "paged" else {}))
    runs = []
    for burst in (None, 4):
        eng = Engine(tree, CFG, **kw)
        reqs = [eng.submit(p, max_new_tokens=9) for p in PROMPTS[:2]]
        eng.run_to_completion(decode_burst=burst)
        runs.append([r.output for r in reqs])
    assert runs[0] == runs[1] and all(len(o) == 9 for o in runs[0])
    assert eng._backend.stats["bursts"] >= 1
