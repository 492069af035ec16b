"""The slice as a whole: the port's Engine against the JAX Engine, and the
JAX engine suite's schedule invariants (tests/test_engine.py:36-78) on the
port alone.

Both engines serve the same tiny model (JAX ``init_params(PRNGKey(0))``,
converted) with 3 greedy requests over 2 slots and an int8 cache.  First
tokens come from one prefill forward and must be equal; later tokens are
held to the JAX suite's own bar, ``agree >= n - 1`` per request, since
near-ties of an untrained model may flip under bf16 rounding differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.serving.sampling import SamplingParams, sample, sample_with_logprob

PROMPTS = [[3, 17, 42, 99, 7], [5, 9, 23, 51], [8, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]
N_NEW = 6
CFG = tl.tiny(attention_impl="bf16")


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


@pytest.mark.parametrize("impl", ["fp8", "bf16"])
def test_engine_matches_jax_engine(jax_params, impl):
    jcfg, tcfg = jl.tiny(attention_impl=impl), tl.tiny(attention_impl=impl)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), tcfg, device="cpu")
    je = JEngine(jax_params, jcfg, num_slots=2, max_len=256, cache_dtype=jnp.int8)
    jr = [je.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    je.run_to_completion()
    te = Engine(tp, tcfg, num_slots=2, max_len=256, cache_dtype=torch.int8)
    tr = [te.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    done = te.run_to_completion()
    assert {r.id for r in done} == {r.id for r in tr}
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == N_NEW
        assert b.output[0] == a.output[0]
        agree = sum(x == y for x, y in zip(a.output, b.output))
        assert agree >= N_NEW - 1, f"port {b.output} vs jax {a.output}"
    for key in ("prefill_tokens", "prefill_forwards", "decode_steps", "generated_tokens"):
        assert te.stats[key] == je.stats[key], key


def greedy_reference(params, prompt, n_new):
    """Teacher-forced greedy decode through the full forward (no cache)."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = tl.forward(params, torch.tensor([toks]), CFG)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_engine_matches_teacher_forcing_bf16_cache(params):
    prompt = [3, 17, 42, 99, 7]
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.bfloat16)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run_to_completion()
    assert req.done
    ref = greedy_reference(params, prompt, 6)
    assert req.output == ref, f"engine {req.output} != teacher-forced {ref}"


def test_engine_int8_cache_close_to_reference(params):
    prompt = [5, 9, 23, 51]
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.int8)
    req = eng.submit(prompt, max_new_tokens=5)
    eng.run_to_completion()
    ref = greedy_reference(params, prompt, 5)
    assert sum(a == b for a, b in zip(req.output, ref)) >= len(ref) - 1


def test_engine_continuous_batching(params):
    """Late arrivals are admitted when slots free up, and batching leaks
    no state across slots: each result equals its solo run."""
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.bfloat16)
    r1 = eng.submit([1, 2, 3], max_new_tokens=4)
    r2 = eng.submit([4, 5, 6, 7], max_new_tokens=2)
    r3 = eng.submit([8, 9], max_new_tokens=3)  # waits for a free slot
    done = eng.run_to_completion()
    assert {r.id for r in done} == {r1.id, r2.id, r3.id}
    assert [len(r.output) for r in (r1, r2, r3)] == [4, 2, 3]
    for req, prompt, n in ((r1, [1, 2, 3], 4), (r3, [8, 9], 3)):
        solo = Engine(params, CFG, num_slots=1, max_len=256, cache_dtype=torch.bfloat16)
        sr = solo.submit(prompt, max_new_tokens=n)
        solo.run_to_completion()
        assert req.output == sr.output


def test_engine_eos_stops_early_and_streams(params):
    prompt = [3, 17, 42, 99, 7]
    probe = Engine(params, CFG, num_slots=1, max_len=256, cache_dtype=torch.bfloat16)
    r0 = probe.submit(prompt, max_new_tokens=4)
    probe.run_to_completion()
    eos = r0.output[1]
    seen = []
    eng = Engine(params, CFG, num_slots=1, max_len=256, cache_dtype=torch.bfloat16)
    req = eng.submit(prompt, max_new_tokens=10, eos_id=eos, on_token=lambda t, r: seen.append(t))
    eng.run_to_completion()
    assert req.output == seen and req.output[-1] == eos and len(req.output) == 2


def test_engine_cancel_and_generate(params):
    eng = Engine(params, CFG, num_slots=1, max_len=256, cache_dtype=torch.int8)
    a = eng.submit([1, 2, 3], max_new_tokens=3)
    b = eng.submit([4, 5], max_new_tokens=3)  # waiting
    eng.cancel(b)
    eng.step()  # a prefills and decodes once
    eng.cancel(a)
    assert a.done and b.done and b.output == [] and len(a.output) == 2
    assert eng.free_slots == [0] and not eng.active
    assert eng.caches[0].lengths.tolist() == [0]
    outs = eng.generate([[7, 8, 9], [1]], max_new_tokens=2)
    assert [len(o) for o in outs] == [2, 2]


def test_engine_logprobs_and_stochastic_sampling(params):
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.int8, seed=1)
    g = eng.submit([1, 2, 3], max_new_tokens=3, logprobs=True)
    s = eng.submit([1, 2, 3], max_new_tokens=3, sampling=SamplingParams(temperature=0.8, top_k=20))
    eng.run_to_completion()
    assert len(g.logprob_output) == 3 and all(lp <= 0.0 for lp in g.logprob_output)
    assert len(s.output) == 3 and all(0 <= t < CFG.vocab_size for t in s.output)


def test_engine_rejects_what_is_not_ported(params):
    # int4 caches are ported (tests/test_torch_kv_int4.py): they construct,
    # and take an 8-bit container only, as in JAX.
    assert Engine(params, CFG, num_slots=1, max_len=64, kv_int4=True).caches[0].k.shape[-1] == CFG.head_dim // 2
    with pytest.raises(ValueError, match="8-bit cache_dtype"):
        Engine(params, CFG, num_slots=1, max_len=64, cache_dtype=torch.bfloat16, kv_int4=True)
    # Tensor-parallel meshes are ported (tests/test_torch_tp_serving.py);
    # the decode block of the TPU's kernel is not.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(params, CFG, decode_block_kv=1024)
    # Speculative decoding is ported (tests/test_torch_speculative.py): the
    # draft that used to be refused now serves.
    spec = Engine(params, CFG, num_slots=1, max_len=64, draft=(params, CFG), spec_tokens=2)
    req = spec.submit([1, 2, 3], max_new_tokens=4)
    spec.run_to_completion()
    assert req.done and len(req.output) == 4 and spec.stats["spec_rounds"] > 0
    # The paged backend, chunked prefill and the prefix cache are ported:
    # the calls that used to be refused now construct.
    eng = Engine(params, CFG, num_slots=1, max_len=256, cache_backend="paged", page_size=64,
                 prefill_chunk=64, prefix_cache=True)
    assert eng.alloc.num_pages == 5 and eng.prefill_chunk == 64
    eng = Engine(params, CFG, num_slots=1, max_len=64)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 60, max_new_tokens=8)
    # Decode bursts are ported: the call that used to be refused now runs.
    req = eng.submit([1, 2], max_new_tokens=2)
    eng.run_to_completion(decode_burst=8)
    assert req.done and len(req.output) == 2


def test_sampling():
    with pytest.raises(ValueError):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32))
    greedy = sample(logits, SamplingParams())
    assert greedy.dtype == torch.int32 and greedy.tolist() == logits.argmax(-1).tolist()
    with pytest.raises(ValueError, match="Generator"):
        sample(logits, SamplingParams(temperature=1.0))
    gen = torch.Generator().manual_seed(0)
    top1 = sample(logits, SamplingParams(temperature=0.7, top_k=1), gen)
    assert top1.tolist() == greedy.tolist()
    nucleus = sample(logits, SamplingParams(temperature=0.7, top_p=1e-6), gen)
    assert nucleus.tolist() == greedy.tolist()
    toks, lps = sample_with_logprob(logits, SamplingParams())
    np.testing.assert_allclose(
        lps.numpy(), torch.log_softmax(logits, -1).max(-1).values.numpy(), rtol=1e-6
    )
