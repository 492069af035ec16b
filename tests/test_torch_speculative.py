"""Speculative decoding in the port, case for case with the JAX package's
tests/test_speculative.py (its sliding-window case is in
tests/test_torch_window_serving.py), on the CPU.

Greedy speculative output must equal plain greedy decoding bit for bit:
the target's argmax decides every emitted token, the draft only how many
target passes it takes.  The models run in float32; the verify pass
(``forward_chunk`` over T tokens, K4's or K10's multi-query plain version)
and the single steps compute the same logits in other orders, so an argmax
could only flip at a near-tie, as in JAX.  The port's paged backend is
deterministic on the CPU, so its outputs are held to plain greedy too
(JAX's paged case asserts only the contract: its CPU paged flow is not).

Against the JAX engine, with the same weights carried over by
``convert.params_from_numpy``: the first tokens (one prefill forward) and
the round statistics' invariants, never whole sequences (ROADMAP caveats).
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
from quantumattention_tpu_torch.serving.sampling import SamplingParams, filtered_probs
from quantumattention_tpu_torch.serving.speculative import speculative_accept

JCFG = jl.tiny(attention_impl="sdpa", dtype=jnp.float32)
JDRAFT = jl.tiny(attention_impl="sdpa", dtype=jnp.float32, num_layers=1, num_q_heads=4, num_kv_heads=2)
CFG = tl.tiny(attention_impl="sdpa", dtype=torch.float32)
DRAFT_CFG = tl.tiny(attention_impl="sdpa", dtype=torch.float32, num_layers=1, num_q_heads=4,
                    num_kv_heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's many small tensor ops: the suite
    runs files in parallel workers, whose default thread pools oversubscribe
    the cores (six parallel runs of this file's engines took 436 s at the
    default and 15 s at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def jax_draft_params():
    return jl.init_params(jax.random.PRNGKey(7), JDRAFT)


def _port(tree, cfg):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")


@pytest.fixture(scope="module")
def params(jax_params):
    return _port(jax_params, CFG)


@pytest.fixture(scope="module")
def draft_params(jax_draft_params):
    return _port(jax_draft_params, DRAFT_CFG)


def _engine(params, **kw):
    kw.setdefault("cache_dtype", torch.bfloat16)
    return Engine(params, CFG, num_slots=2, max_len=256, device="cpu", **kw)


def greedy_engine_output(params, prompt, n_new, **kw):
    eng = _engine(params, **kw)
    req = eng.submit(prompt, max_new_tokens=n_new)
    eng.run_to_completion()
    return req.output


#: (backend, cache type, int4): greedy speculative decoding over each.
CACHES = {
    "slots-bf16": dict(cache_dtype=torch.bfloat16),
    "slots-int4": dict(cache_dtype=torch.int8, kv_int4=True),
    "slots-f16": dict(cache_dtype=torch.float16),
    "paged-bf16": dict(cache_dtype=torch.bfloat16, cache_backend="paged", page_size=64),
    "paged-int4": dict(cache_dtype=torch.int8, kv_int4=True, cache_backend="paged", page_size=64),
    "paged-f32": dict(cache_dtype=torch.float32, cache_backend="paged", page_size=64),
}


@pytest.mark.parametrize("cache", list(CACHES))
def test_speculative_matches_plain_greedy(params, draft_params, cache):
    prompt = [5, 9, 23, 51, 7]
    kw = CACHES[cache]
    plain = greedy_engine_output(params, prompt, 12, **kw)
    eng = _engine(params, draft=(draft_params, DRAFT_CFG), spec_tokens=3, **kw)
    req = eng.submit(prompt, max_new_tokens=12)
    eng.run_to_completion()
    assert req.output == plain
    assert eng.stats["spec_rounds"] > 0
    if "paged" in cache:
        assert int(eng.alloc.allocated.sum()) == 0  # every page returned


#: Self-draft runs: both backends, so that rounds whose proposals are
#: accepted also roll the paged backend back to what they accepted.
SELF_DRAFT = ["slots-bf16", "slots-int4", "paged-bf16", "paged-int4", "paged-f32"]


@pytest.mark.parametrize("cache", SELF_DRAFT)
def test_speculative_self_draft_accepts_everything(params, cache):
    """The target as its own draft: every proposal is accepted, so a round
    emits spec_tokens + 1 tokens, and the output is plain greedy's.  Over
    an int4 target cache the draft's own cache is int8 (it takes the
    cache type without kv_int4, as JAX's engine.py:248-258 does), so only
    some proposals are accepted."""
    prompt = [3, 17, 42]
    kw = CACHES[cache]
    plain = greedy_engine_output(params, prompt, 9, **kw)
    eng = _engine(params, draft=(params, CFG), spec_tokens=2, **kw)
    req = eng.submit(prompt, max_new_tokens=9)
    steps = 0
    while not req.done:
        eng.step()
        steps += 1
    assert req.output == plain
    if "int4" in cache:
        assert 0 < eng.stats["spec_accepted"] <= eng.stats["spec_proposed"]
    else:
        # 9 tokens: the prefill's first, then rounds of 3 (2 accepted and the bonus).
        assert steps <= 5, steps
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0
    if "paged" in cache:
        assert int(eng.alloc.allocated.sum()) == 0  # every page returned


def test_speculative_continuous_batching(params, draft_params):
    """Two concurrent requests through the rounds; each equals its solo
    plain-greedy output."""
    eng = _engine(params, draft=(draft_params, DRAFT_CFG), spec_tokens=3)
    r1 = eng.submit([1, 2, 3], max_new_tokens=7)
    r2 = eng.submit([9, 8, 7, 6], max_new_tokens=5)
    eng.run_to_completion()
    assert r1.output == greedy_engine_output(params, [1, 2, 3], 7)
    assert r2.output == greedy_engine_output(params, [9, 8, 7, 6], 5)


def test_speculative_eos_mid_round(params, draft_params):
    prompt = [3, 17, 42, 99, 7]
    plain = greedy_engine_output(params, prompt, 8)
    eos = plain[2]  # stop at the third generated token
    expect = plain[: plain.index(eos) + 1]
    assert greedy_engine_output(params, prompt, 8, draft=(draft_params, DRAFT_CFG),
                                spec_tokens=4) == plain
    eng = _engine(params, draft=(draft_params, DRAFT_CFG), spec_tokens=4)
    req = eng.submit(prompt, max_new_tokens=8, eos_id=eos)
    eng.run_to_completion()
    assert req.output == expect


def test_speculative_paged_pool_pressure_falls_back(params, draft_params):
    """When the pool cannot cover a round's growth the engine decodes a
    token at a time (and still completes) rather than running out of pages
    mid-round."""
    prompt = list(range(1, 60))  # about a page of prompt at page_size 64
    eng = _engine(params, cache_backend="paged", page_size=64, num_pages=3,
                  draft=(draft_params, DRAFT_CFG), spec_tokens=3)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run_to_completion()
    assert req.done and len(req.output) == 6
    assert req.output == greedy_engine_output(params, prompt, 6)


def test_speculative_stochastic_requests_complete(params, draft_params):
    """Stochastic requests run the rejection-sampling rounds (their
    exactness is the statistical test below): they complete within budget
    with tokens in the vocabulary."""
    eng = _engine(params, draft=(draft_params, DRAFT_CFG), spec_tokens=3)
    sp = SamplingParams(temperature=0.8, top_k=10)
    reqs = [eng.submit([4, 5, 6], max_new_tokens=6, sampling=sp),
            eng.submit([9, 1, 2, 7], max_new_tokens=4, sampling=sp)]
    eng.run_to_completion()
    assert len(reqs[0].output) == 6 and len(reqs[1].output) == 4
    assert all(0 <= t < CFG.vocab_size for r in reqs for t in r.output)
    assert eng.stats["spec_rounds"] > 0
    assert eng.stats["spec_accepted"] <= eng.stats["spec_proposed"]


def test_speculative_mixed_sampling_falls_back(params, draft_params):
    """Requests with different sampling settings cannot share a round: the
    engine decodes a token at a time and completes."""
    eng = _engine(params, draft=(draft_params, DRAFT_CFG))
    r1 = eng.submit([4, 5, 6], max_new_tokens=4)
    r2 = eng.submit([7, 8], max_new_tokens=3, sampling=SamplingParams(temperature=0.7))
    eng.run_to_completion()
    assert len(r1.output) == 4 and len(r2.output) == 3


def test_speculative_near_max_len_falls_back(params, draft_params):
    """Verification writes spec_tokens + 1 rows before acceptance: near
    max_len the engine decodes a token at a time and still finishes with
    plain greedy's tokens."""
    prompt = list(range(1, 25))  # 24 tokens, room for 8 more
    plain = Engine(params, CFG, num_slots=1, max_len=32, cache_dtype=torch.bfloat16, device="cpu")
    pr = plain.submit(prompt, max_new_tokens=8)
    plain.run_to_completion()
    eng = Engine(params, CFG, num_slots=1, max_len=32, cache_dtype=torch.bfloat16,
                 draft=(draft_params, DRAFT_CFG), spec_tokens=4, device="cpu")
    req = eng.submit(prompt, max_new_tokens=8)
    eng.run_to_completion()
    assert req.output == pr.output


def test_speculative_logprob_requests_fall_back(params, draft_params):
    """A request asking for logprobs decodes a token at a time (a round
    keeps no per-position distribution), and the draft's decode bursts stay
    off: ``decode_burst`` changes nothing under a draft."""
    eng = _engine(params, draft=(draft_params, DRAFT_CFG))
    req = eng.submit([4, 5, 6], max_new_tokens=4, logprobs=True)
    eng.run_to_completion(decode_burst=8)
    assert len(req.output) == 4 and len(req.logprob_output) == 4
    assert eng.stats["spec_rounds"] == 0 and eng._backend.stats["bursts"] == 0


def test_rejection_scheme_preserves_target_distribution():
    """Leviathan et al., Theorem 1: the first emitted token is distributed
    exactly as the target's p, however poor the draft's q.  50k trials in
    one vectorized call over a vocabulary of 8."""
    v, n = 8, 50_000
    rng = np.random.default_rng(0)
    p = torch.softmax(torch.from_numpy(rng.standard_normal(v).astype(np.float32)) * 1.5, dim=-1)
    q = torch.softmax(torch.from_numpy(rng.standard_normal(v).astype(np.float32)) * 1.5, dim=-1)
    gen = torch.Generator().manual_seed(0)
    x = torch.multinomial(q, n, replacement=True, generator=gen)  # proposals ~ q
    n_acc, final = speculative_accept(gen, q.expand(n, 1, v), p.expand(n, 2, v), x[:, None])
    toks = torch.where(n_acc >= 1, x, final.long())
    emp = np.bincount(toks.numpy(), minlength=v) / n
    # Multinomial std a bin ~ sqrt(p / N) <= 0.0025: 4 sigma and some slack.
    assert np.abs(emp - p.numpy()).max() < 0.012, (emp, p.numpy())


def test_rejection_scheme_self_draft_accepts_all():
    """q == p: every proposal is accepted, and the final token comes from
    the bonus distribution."""
    v, gamma = 8, 3
    p = torch.softmax(torch.from_numpy(np.random.default_rng(1).standard_normal(v).astype(np.float32)),
                      dim=-1)
    n_acc, final = speculative_accept(torch.Generator().manual_seed(2), p.expand(1, gamma, v),
                                      p.expand(1, gamma + 1, v), torch.tensor([[2, 5, 1]]))
    assert n_acc.dtype == torch.int32 and int(n_acc[0]) == gamma
    assert 0 <= int(final[0]) < v


def test_filtered_probs_matches_jax():
    from quantumattention_tpu.serving import sampling as js

    logits = np.random.default_rng(3).standard_normal((3, 32)).astype(np.float32)
    for sp in (SamplingParams(temperature=0.8), SamplingParams(temperature=0.7, top_k=5),
               SamplingParams(temperature=1.0, top_p=0.9)):
        got = filtered_probs(torch.from_numpy(logits), sp).numpy()
        want = np.asarray(js.filtered_probs(jnp.asarray(logits), js.SamplingParams(
            temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p)))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_speculative_engine_matches_jax_engine(jax_params, jax_draft_params, params, draft_params):
    """The same weights in both packages, one greedy request, a draft:
    equal first tokens, and both engines' round statistics keep their
    invariants (spec_tokens proposals a round for the one active slot, at
    most as many accepted)."""
    prompt, n_new, gamma = [5, 9, 23, 51, 7], 10, 3
    je = JEngine(jax_params, JCFG, num_slots=2, max_len=256, cache_dtype=jnp.bfloat16,
                 draft=(jax_draft_params, JDRAFT), spec_tokens=gamma)
    jr = je.submit(prompt, max_new_tokens=n_new)
    je.run_to_completion()
    te = _engine(params, draft=(draft_params, DRAFT_CFG), spec_tokens=gamma)
    tr = te.submit(prompt, max_new_tokens=n_new)
    te.run_to_completion()
    assert len(tr.output) == len(jr.output) == n_new
    assert tr.output[0] == jr.output[0]
    for stats in (te.stats, je.stats):
        assert stats["spec_rounds"] > 0
        assert stats["spec_proposed"] == gamma * stats["spec_rounds"]
        assert stats["spec_accepted"] <= stats["spec_proposed"]
        assert stats["generated_tokens"] == n_new
