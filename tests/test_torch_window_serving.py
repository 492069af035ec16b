"""Sliding-window models served and speculated on both backends, on the CPU.

A ``tiny(window=8)`` model (JAX ``init_params``, converted) runs through
the port's engine with prompts longer than the window, so that prefill,
chunked prefill, decode (K4 / K10 / K9's plain versions) and verification
all have to honour it.  Held:

- against the port's own teacher-forced forward (``llama.forward``, the
  windowed oracle path): the first token exactly, later tokens by the JAX
  suite's bar ``agree >= n - 1`` (near-ties of an untrained model may flip
  under rounding, tests/test_engine.py:579 asserts exact sequences on its
  slots path only), and one decode step's logits within 2% relative
  Frobenius error of the forward's last position (a full-causal step
  misses by more than ten times that);
- against the JAX engine with the same weights: the first tokens (one
  prefill forward), never whole sequences;
- a chunk's attention over the prefix cut to its window
  (``backends.prefix_start``, K1 with ``kv_offset``) against the same
  chunk over the whole prefix: K1's bar of 1/32;
- speculative decoding (the mirror of tests/test_speculative.py:283):
  greedy output equal to plain greedy on both backends, as
  tests/test_torch_speculative.py holds it, and every page returned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch import config as tconfig
from quantumattention_tpu_torch.models import convert, quantized
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import megastep
from quantumattention_tpu_torch.serving import backends
from quantumattention_tpu_torch.serving.engine import Engine

WINDOW = 8
JCFG = jl.tiny(attention_impl="sdpa", dtype=jnp.float32, window=WINDOW)
CFG = tl.tiny(attention_impl="sdpa", dtype=torch.float32, window=WINDOW)
JDRAFT = jl.tiny(attention_impl="sdpa", dtype=jnp.float32, window=WINDOW, num_layers=1,
                 num_q_heads=4, num_kv_heads=2)
DRAFT_CFG = tl.tiny(attention_impl="sdpa", dtype=torch.float32, window=WINDOW, num_layers=1,
                    num_q_heads=4, num_kv_heads=2)
PROMPT = list(range(1, 21))  # 20 tokens: decode runs past the window
N_NEW = 6
LOGIT_REL = 2e-2
K1_ATOL = 1.0 / 32
#: (label, Engine keywords): whole prefill and chunked prefill on the slots
#: backend, the paged backend with and without chunks.
BACKENDS = {
    "slots": dict(cache_dtype=torch.float32),
    "slots-chunked": dict(cache_dtype=torch.float32, prefill_chunk=16),
    "paged": dict(cache_dtype=torch.float32, cache_backend="paged", page_size=16),
    "paged-chunked": dict(cache_dtype=torch.float32, cache_backend="paged", page_size=16,
                          prefill_chunk=16),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(3), JCFG)


def _port(tree, cfg):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")


@pytest.fixture(scope="module")
def params(jax_params):
    return _port(jax_params, CFG)


@pytest.fixture(scope="module")
def draft_params():
    return _port(jl.init_params(jax.random.PRNGKey(12), JDRAFT), DRAFT_CFG)


def teacher_forced(params, prompt, n_new, cfg=CFG):
    """Greedy decode through the full windowed forward (no cache)."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = tl.forward(params, torch.tensor([toks]), cfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_window_engine_matches_teacher_forcing(params, jax_params, backend):
    """The mirror of tests/test_engine.py:579 by invariants and first tokens."""
    ref = teacher_forced(params, PROMPT, N_NEW)
    eng = Engine(params, CFG, num_slots=2, max_len=64, device="cpu", **BACKENDS[backend])
    req = eng.submit(PROMPT, max_new_tokens=N_NEW)
    eng.run_to_completion()
    assert req.done and len(req.output) == N_NEW
    assert req.output[0] == ref[0]
    assert sum(a == b for a, b in zip(req.output, ref)) >= N_NEW - 1, (req.output, ref)
    jkw = {k: v for k, v in BACKENDS[backend].items() if k != "cache_dtype"}
    je = JEngine(jax_params, JCFG, num_slots=2, max_len=64, cache_dtype=jnp.float32, **jkw)
    jr = je.submit(PROMPT, max_new_tokens=N_NEW)
    je.run_to_completion()
    assert jr.output[0] == req.output[0]
    if backend == "paged":
        assert int(eng.alloc.allocated.sum()) == 0


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_window_decode_step_logits_match_forward(params, backend):
    """One decode step past the window against the forward's last
    position; the same step without the window is far off."""
    eng = Engine(params, CFG, num_slots=2, max_len=64, device="cpu", **BACKENDS[backend])
    req = eng.submit(PROMPT, max_new_tokens=N_NEW)
    while len(req.output) < 3:
        eng.step()
    toks = PROMPT + req.output
    be = eng._backend
    n = int(be.host_lengths()[req.slot])
    assert n == len(toks) - 1 > 2 * WINDOW
    cur = np.zeros(2, np.int64)
    cur[req.slot] = toks[-1]
    active = np.zeros(2, bool)
    active[req.slot] = True
    step = be.decode(params, cur, active, [req.slot])[req.slot]
    want = tl.forward(params, torch.tensor([toks]), CFG)[0, -1]
    full = tl.forward(params, torch.tensor([toks]), tl.tiny(attention_impl="sdpa",
                                                            dtype=torch.float32))[0, -1]
    assert _rel(step, want) < LOGIT_REL
    assert _rel(full, want) > 10 * _rel(step, want)


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_chunk_over_the_cut_prefix_equals_the_whole_prefix(params, backend, monkeypatch):
    """Chunked prefill gathers only the prefix rows inside the chunk's
    window; the chunk's attention equals the call over the whole prefix."""
    calls = []
    real = backends.flash_attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        start = kw["kv_offset"]
        if start > 0:
            off = kw["q_offset"]
            assert k.shape[2] == off - start + q.shape[2]
            calls.append((q, k, v, kw, out))
        return out

    monkeypatch.setattr(backends, "flash_attention", spy)
    eng = Engine(params, CFG, num_slots=1, max_len=64, device="cpu",
                 **BACKENDS[f"{backend}-chunked"])
    eng.submit(PROMPT + list(range(30, 50)), max_new_tokens=2)
    eng.run_to_completion()
    assert calls
    for q, k, v, kw, out in calls:
        assert kw["kv_offset"] == kw["q_offset"] - (WINDOW - 1)
        # The same chunk over the whole prefix from row 0: the rows before
        # the cut hide behind the window, whatever they hold.
        gen = torch.Generator().manual_seed(kw["q_offset"])
        pad = torch.randn(k.shape[:2] + (kw["kv_offset"], k.shape[3]), generator=gen).to(k.dtype)
        whole = real(q, torch.cat([pad, k], 2), torch.cat([pad, v], 2), is_causal=True,
                     q_offset=kw["q_offset"], window=kw["window"])
        assert float((whole.float() - out.float()).abs().max()) <= K1_ATOL


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_window_speculative_matches_plain_greedy(params, draft_params, backend):
    """The mirror of tests/test_speculative.py:283 on both backends."""
    kw = dict(BACKENDS[backend])
    plain = Engine(params, CFG, num_slots=1, max_len=64, device="cpu", **kw)
    pr = plain.submit(PROMPT[:14], max_new_tokens=8)
    plain.run_to_completion()
    spec = Engine(params, CFG, num_slots=1, max_len=64, device="cpu",
                  draft=(draft_params, DRAFT_CFG), spec_tokens=3, **kw)
    sr = spec.submit(PROMPT[:14], max_new_tokens=8)
    spec.run_to_completion()
    assert sr.output == pr.output
    assert spec.stats["spec_rounds"] > 0
    if backend == "paged":
        assert int(spec.alloc.allocated.sum()) == 0


def test_window_megastep_step_matches_lean_step(monkeypatch):
    """A window model's fused int8 decode step (K9's plain version, the
    window in its step context) against the lean step through K4's plain
    version with the window, on the same cache state."""
    cfg = tl.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                  head_dim=128, num_layers=2, window=WINDOW, attention_impl="bf16")
    gen = torch.Generator().manual_seed(5)
    tree = quantized.fuse_projections(quantized.quantize_params(tl.init_params(gen, cfg, "cpu")))
    seen = []
    real = megastep.fused_decode_layer

    def spy(*args, **kw):
        seen.append(args[6]["window_left"])
        return real(*args, **kw)

    monkeypatch.setattr(backends.megastep, "fused_decode_layer", spy)
    logits = {}
    for flag in ("force", False):
        with tconfig.patch({"kernel.megastep": flag, "kernel.qmm": "force",
                            "kernel.qmlp": "force"}):
            be = backends.SlotsBackend(cfg, num_slots=16, max_len=64, device="cpu")
            prompts = [list(range(3 + i, 3 + i + 12 + i)) for i in range(16)]
            for slot, p in enumerate(prompts):
                be.prefill_and_write(
                    lambda prm, toks, last_pos: tl.forward_prefill(prm, toks, cfg,
                                                                   last_pos=last_pos),
                    tree, torch.tensor([p]), [len(p) - 1], [slot], [len(p)], len(p))
            assert be.route(tree) == ("mega" if flag else "unfused")
            logits[flag] = be.decode(tree, np.arange(16) + 7, np.ones(16, bool))
    assert seen == [WINDOW - 1] * cfg.num_layers
    assert _rel(logits["force"], logits[False]) < 5e-2
