"""The paged slice as a whole on the CPU: ``PagedBackend``, chunked prefill
on both backends, and the engine with a page pool and prefix caching.

- One paged decode step against JAX's ``PagedBackend`` on the same tree and
  page state (a bf16 tree through the generic decoder over bf16 pages, and
  an int8 fused tree through the lean T=1 decode and K8's plain version over
  int8 pages): logits within 2e-2 RMSE / std, the JAX suite's bar for
  decode steps (tests/test_megastep.py); JAX's kernel runs its interpret
  default (the gathered reference, K4's rounding), the port K10's.  JAX's
  step runs un-jitted (``jax.disable_jit``): its jitted paged step on the
  CPU returns wrong logits intermittently (a fault of that runtime that
  ROADMAP queue 3's caveats record; margins of order 1 against its own
  slots step here).
- Chunk logits of ``prefill_chunk`` against JAX's, cold and after a prefix
  hit, at the same bar; the chunk attention is K1 with ``q_offset`` on both.
- The paged engine against JAX's paged engine with prefix caching: first
  tokens equal (one prefill forward each), counters equal.  Later tokens of
  an untrained model are not compared (near-ties flip under bf16 rounding
  differences, and JAX's CPU paged engine is nondeterministic: ROADMAP
  queue 3's caveats).
- The port alone, mirroring tests/test_engine.py:112-349,771-849 and
  tests/test_prefix_cache.py:137-210: paged against slots, chunked against
  whole prefill on both backends, page reuse, backpressure, the oversized
  request and alignment errors, prefix-cache reuse and refcounts, bursts
  against per-step decode, and the trash page.  On one device the port is
  deterministic, so where JAX's suite can only compare invariants these
  tests compare tokens: equal for bf16 caches, the JAX suite's
  ``agree >= n - 1`` for int8 caches, whose chunked prefill re-reads a
  quantized prefix that the whole prefill never does.
- Called without a device, the caches, page pools, backends and
  ``params_from_numpy`` take the CUDA card, and raise without one.
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
from quantumattention_tpu.serving import paged_cache as jpgc
from quantumattention_tpu.serving.backends import PagedBackend as JPaged
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.serving import kv_cache as kvc
from quantumattention_tpu_torch.serving import paged_cache as pgc
from quantumattention_tpu_torch.serving.backends import PagedBackend, SlotsBackend
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.utils import checks

STEP_BAR = 2e-2
CFG = tl.tiny(attention_impl="bf16")
SHAPES = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
              num_q_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(_np(jax_params), CFG, device="cpu")


@pytest.fixture(scope="module")
def trees():
    """(jax tree, port tree, jax cfg, port cfg, cache dtype, config patch)
    for the bf16 tree over bf16 pages and the int8 fused tree over int8."""
    jcfg, tcfg = jl.LlamaConfig(**SHAPES), tl.LlamaConfig(**SHAPES)
    bf = jl.init_params(jax.random.PRNGKey(1), jcfg)
    i8 = jq.fuse_projections(jq.init_quantized_params(jax.random.PRNGKey(2), jcfg))
    return {
        "bf16": (bf, convert.params_from_numpy(_np(bf), tcfg, device="cpu"), jcfg, tcfg,
                 (torch.bfloat16, jnp.bfloat16), {}),
        "int8": (i8, convert.params_from_numpy(_np(i8), tcfg, device="cpu"), jcfg, tcfg,
                 (torch.int8, jnp.int8), {"kernel.qmlp": "force"}),
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.std(b))


@pytest.mark.parametrize("tree", ["bf16", "int8"])
def test_paged_decode_step_matches_jax(trees, tree):
    jtree, ttree, jcfg, tcfg, (tdt, jdt), patch = trees[tree]
    slots, ps, max_len = 4, 32, 128
    rng = np.random.default_rng(3)
    hkv, d = SHAPES["num_kv_heads"], SHAPES["head_dim"]
    tp = PagedBackend(tcfg, num_slots=slots, max_len=max_len, cache_dtype=tdt, page_size=ps,
                      device="cpu")
    jp = JPaged(jcfg, num_slots=slots, max_len=max_len, cache_dtype=jdt, page_size=ps)
    n_pool = tp.alloc.num_pages + 1
    jpages = []
    for lp in tp.pages:
        shape = (hkv, n_pool, ps, d)
        if tdt == torch.int8:
            vals = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
            scs = [(rng.random(shape[:3]) * 0.02 + 0.005).astype(np.float32) for _ in range(2)]
            for dst, src in zip((lp.k, lp.v, lp.k_scale, lp.v_scale), vals + scs):
                dst.copy_(torch.from_numpy(src))
            jpages.append(jpgc.LayerPages(k=jnp.asarray(vals[0]), v=jnp.asarray(vals[1]),
                                          k_scale=jnp.asarray(scs[0]), v_scale=jnp.asarray(scs[1])))
        else:
            vals = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                    for _ in range(2)]
            lp.k.copy_(vals[0])
            lp.v.copy_(vals[1])
            jpages.append(jpgc.LayerPages(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                                            for x in vals)))
    jp.pages = jpages
    lengths = np.array([37, 0, 100, 5], np.int32)
    for be in (tp, jp):
        for s, n in enumerate(lengths):
            be.alloc.allocate(s, int(n) + 8, ps)
        be.alloc.lengths[:] = lengths
    np.testing.assert_array_equal(tp.alloc.tables, jp.alloc.tables)
    tokens = np.array([7, 0, 99, 201], np.int32)
    active = np.array([True, False, True, True])
    with config.patch(patch):
        got = tp.decode(ttree, tokens, active, [0, 2, 3]).numpy()
    with jconfig.patch(patch), jax.disable_jit():
        jp.pages, want = jp._decode_step_impl(
            jtree, jp.pages, jnp.asarray(tokens), jnp.asarray(jp.alloc.tables),
            jnp.asarray(jp.alloc.lengths), jnp.asarray(active))
    want = np.asarray(want)
    assert np.isfinite(got).all() and _rel(got[active], want[active]) < STEP_BAR
    np.testing.assert_array_equal(tp.host_lengths(), lengths + active)
    # The written rows: each active slot's token at its position, inactive
    # lanes in the trash page, every other row as it was.
    for lp, jlp in zip(tp.pages, jp.pages):
        for mine, theirs in ((lp.k, jlp.k), (lp.v, jlp.v)):
            a = mine.float().numpy()
            b = np.asarray(theirs.astype(jnp.float32))
            same = np.isclose(a, b, rtol=0, atol=0).all(axis=(0, 3))
            for s in np.flatnonzero(active):
                page, row = tp.alloc.tables[s, lengths[s] // ps], lengths[s] % ps
                same[page, row] = True
            same[tp._trash_page] = True
            assert same.all()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_prefill_chunk_logits_match_jax(jax_params, params, kind):
    """Cold chunks of a 100-token prompt, then the same prompt hot (three
    pages adopted, prefill resumes at 96 with q_offset 96), on both
    backends from one admission sequence."""
    tdt, jdt = (torch.int8, jnp.int8) if kind == "int8" else (torch.bfloat16, jnp.bfloat16)
    jcfg = jl.tiny(attention_impl="bf16")
    tp = PagedBackend(CFG, num_slots=2, max_len=256, cache_dtype=tdt, page_size=32,
                      prefix_cache=True, device="cpu")
    jp = JPaged(jcfg, num_slots=2, max_len=256, cache_dtype=jdt, page_size=32, prefix_cache=True)
    prompt = [(3 * i) % 97 + 1 for i in range(100)]
    chunk = 64

    @dataclasses.dataclass
    class Req:
        prompt: list
        slot: int

    for slot in (0, 1):
        req = Req(prompt, slot)
        off = [b.try_admit(req, slot, 128) for b in (tp, jp)]
        assert off[0] == off[1] == (0 if slot == 0 else 96)
        off = off[0]
        while off < len(prompt):
            tc = min(chunk, len(prompt) - off)
            toks = np.zeros((1, chunk), np.int64)
            toks[0, :tc] = prompt[off : off + tc]
            got = tp.prefill_chunk(params, torch.from_numpy(toks), req, off, tc)[0, :tc].numpy()
            want = np.asarray(jp.prefill_chunk(jax_params, jnp.asarray(toks, jnp.int32), req, off, tc))
            assert _rel(got, want[0, :tc]) < STEP_BAR, (slot, off)
            off += tc
        for b in (tp, jp):
            b.register_prefix(req)
        np.testing.assert_array_equal(tp.alloc.lengths, jp.alloc.lengths)
    np.testing.assert_array_equal(tp.alloc.tables[:, :4], jp.alloc.tables[:, :4])


def test_paged_engine_matches_jax_paged_engine(jax_params, params):
    shared = [(5 * i) % 200 + 1 for i in range(70)]
    prompts = [shared + [9, 8, 7], shared + [1], list(range(3, 40)), shared + [2, 2]]
    kw = dict(num_slots=2, max_len=256, cache_backend="paged", page_size=32, prefill_chunk=64,
              prefix_cache=True)
    je = JEngine(jax_params, jl.tiny(attention_impl="bf16"), cache_dtype=jnp.int8, **kw)
    jr = [je.submit(p, max_new_tokens=4) for p in prompts]
    je.run_to_completion()
    te = Engine(params, CFG, cache_dtype=torch.int8, **kw)
    tr = [te.submit(p, max_new_tokens=4) for p in prompts]
    te.run_to_completion()
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == 4
        assert b.output[0] == a.output[0]
    for key in ("prefill_tokens", "prefill_forwards", "generated_tokens", "prefix_hits",
                "prefix_tokens_reused"):
        assert te.stats[key] == je.stats[key], key
    assert te.stats["prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# The port alone (tests/test_engine.py, tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------


def _run(params, prompts, n_new, burst=None, **kw):
    eng = Engine(params, CFG, **{"num_slots": 2, "max_len": 256, **kw})
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run_to_completion(decode_burst=burst)
    return eng, reqs


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_engine_matches_slots_engine(params, kind):
    dt = torch.int8 if kind == "int8" else torch.bfloat16
    prompts = [[3, 17, 42, 99, 7], list(range(3, 60))]
    _, slots = _run(params, prompts, 6, cache_dtype=dt)
    _, paged = _run(params, prompts, 6, cache_dtype=dt, cache_backend="paged", page_size=64)
    for a, b in zip(slots, paged):
        assert b.done and len(b.output) == 6 and b.output[0] == a.output[0]
        if kind == "bf16":
            assert b.output == a.output
        else:
            assert sum(x == y for x, y in zip(a.output, b.output)) >= 5


def test_paged_engine_page_reuse(params):
    eng = Engine(params, CFG, num_slots=1, max_len=256, cache_dtype=torch.bfloat16,
                 cache_backend="paged", page_size=64, num_pages=5)
    free0 = eng.alloc.free_pages
    r1 = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run_to_completion()
    assert r1.done and eng.alloc.free_pages == free0
    r2 = eng.submit([4, 5, 6, 7, 8], max_new_tokens=3)
    eng.run_to_completion()
    assert r2.done and len(r2.output) == 3


@pytest.mark.parametrize("backend", ["slots", "paged"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_chunked_prefill_matches_whole(params, backend, kind):
    """87 tokens in three chunks of 32 against one whole prefill."""
    dt = torch.int8 if kind == "int8" else torch.bfloat16
    kw = dict(cache_dtype=dt, num_slots=1)
    if backend == "paged":
        kw.update(cache_backend="paged", page_size=32)
    prompt = list(range(3, 90))
    _, (whole,) = _run(params, [prompt], 4, **kw)
    eng, (chunked,) = _run(params, [prompt], 4, prefill_chunk=32, **kw)
    assert eng.stats["prefill_forwards"] == 3 and eng.stats["prefill_tokens"] == 87
    if kind == "bf16":
        assert chunked.output == whole.output
    else:
        assert sum(a == b for a, b in zip(chunked.output, whole.output)) >= 3


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_decode_not_starved_by_prefill(params, backend):
    """A decoding request advances every step while another prefills in
    chunks, and its cached rows stay bitwise untouched."""
    kw = {"page_size": 32} if backend == "paged" else {}
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.bfloat16,
                 prefill_chunk=32, cache_backend=backend, **kw)
    ra = eng.submit([1, 2, 3], max_new_tokens=12)
    eng.step()
    assert len(ra.output) >= 1

    def rows_of_a(n):
        if backend == "paged":
            ids = torch.from_numpy(eng.alloc.tables[ra.slot, : -(-n // 32)]).long()
            return [t[:, ids].reshape(t.shape[0], -1, t.shape[3])[:, :n].clone()
                    for lp in eng.pages for t in (lp.k, lp.v)]
        return [t[ra.slot, :, :n].clone() for c in eng.caches for t in (c.k, c.v)]

    n0 = int(eng._backend.host_lengths()[ra.slot])
    snap = rows_of_a(n0)
    rb = eng.submit(list(range(3, 100)), max_new_tokens=2)
    while rb.prefill_pos < len(rb.prompt):
        before = len(ra.output)
        eng.step()
        assert len(ra.output) == before + 1 and rb.prefill_pos > 0
        assert all(torch.equal(a, b) for a, b in zip(snap, rows_of_a(n0)))
    eng.run_to_completion()
    assert len(ra.output) == 12 and len(rb.output) == 2


def test_paged_validation_errors(params):
    with pytest.raises(ValueError, match="page_size"):
        Engine(params, CFG, num_slots=1, max_len=250, cache_backend="paged", page_size=64)
    with pytest.raises(ValueError, match="prefill_bucket"):
        Engine(params, CFG, num_slots=1, max_len=256, cache_backend="paged", page_size=64,
               prefill_bucket=96)
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(params, CFG, num_slots=1, max_len=256, cache_backend="paged", page_size=64,
               prefill_chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        Engine(params, CFG, num_slots=1, max_len=200, prefill_chunk=64)
    with pytest.raises(ValueError, match="cache_backend"):
        Engine(params, CFG, cache_backend="pages")
    with pytest.raises(ValueError, match="paged"):
        Engine(params, CFG, num_slots=2, max_len=256, prefix_cache=True, prefill_chunk=64)
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(params, CFG, num_slots=2, max_len=256, cache_backend="paged", page_size=32,
               prefix_cache=True)
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.bfloat16,
                 cache_backend="paged", page_size=64, num_pages=2)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(3, 150)), max_new_tokens=32)  # needs 3 of 2 pages


def test_paged_backpressure(params):
    """Requests beyond the pool wait, then run when pages free up; the
    reservation covers the padded prompt and every new token."""
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.bfloat16,
                 cache_backend="paged", page_size=64, num_pages=4)
    r1 = eng.submit(list(range(1, 100)), max_new_tokens=40)  # 139 tokens: 3 pages
    r2 = eng.submit([4, 5, 6], max_new_tokens=20)            # 128 padded: 2 pages
    eng.step()
    assert r1.slot is not None and r2.slot is None and r2 in eng.waiting
    done = eng.run_to_completion()
    assert {r.id for r in done} == {r1.id, r2.id}
    assert len(r1.output) == 40 and len(r2.output) == 20
    assert eng.alloc.free_pages == 4


def _prefix_engine(params, **kw):
    return Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.int8,
                  cache_backend="paged", page_size=32, prefill_chunk=64, prefix_cache=True, **kw)


def test_prefix_cache_reuses_pages(params):
    eng = _prefix_engine(params)
    prompt = [(3 * i) % 97 + 1 for i in range(100)]  # 3 whole pages and a tail
    a = eng.submit(list(prompt), max_new_tokens=3)
    eng.run_to_completion()
    assert eng.stats["prefix_hits"] == 0
    tokens_before = eng.stats["prefill_tokens"]
    b = eng.submit(list(prompt), max_new_tokens=3)
    eng.run_to_completion()
    assert b.done and len(b.output) == 3
    assert eng.stats["prefix_hits"] == 1 and eng.stats["prefix_tokens_reused"] == 96
    assert eng.stats["prefill_tokens"] - tokens_before == len(prompt) - 96
    assert eng.alloc.evictable_pages >= 3
    assert b.output == a.output  # the same cached rows, the same step on one device


def test_prefix_cache_shared_while_live(params):
    eng = _prefix_engine(params)
    prompt = [(5 * i) % 89 + 1 for i in range(70)]  # 2 whole pages
    a = eng.submit(list(prompt), max_new_tokens=30)
    while a.prefill_pos < len(prompt):
        eng.step()
    b = eng.submit(list(prompt) + [7, 7], max_new_tokens=3)
    eng.step()
    assert eng.stats["prefix_hits"] == 1 and a.slot != b.slot
    np.testing.assert_array_equal(eng.alloc.tables[a.slot, :2], eng.alloc.tables[b.slot, :2])
    assert eng.alloc.refs[int(eng.alloc.tables[a.slot, 0])] == 2
    eng.run_to_completion()
    assert len(a.output) == 30 and len(b.output) == 3
    assert all(v == 0 for v in eng.alloc.refs.values())


def test_prefix_cache_capped_below_full_prompt(params):
    """A page-aligned identical prompt still prefills >= 1 token."""
    eng = _prefix_engine(params)
    prompt = [(2 * i) % 61 + 1 for i in range(64)]  # exactly 2 pages
    eng.submit(list(prompt), max_new_tokens=2)
    eng.run_to_completion()
    before = eng.stats["prefill_tokens"]
    b = eng.submit(list(prompt), max_new_tokens=2)
    eng.run_to_completion()
    assert b.done and eng.stats["prefix_tokens_reused"] == 32
    assert eng.stats["prefill_tokens"] - before == 32


def test_prefix_hit_writes_only_its_own_pages(params):
    """A hot chunk shorter than the chunk width writes only the pages of its
    real rows: the page past its reservation, which a full-width write would
    hit, is left alone."""
    eng = _prefix_engine(params)
    prompt = [(3 * i) % 97 + 1 for i in range(100)]
    eng.submit(list(prompt), max_new_tokens=3)
    eng.run_to_completion()
    pool = [t.clone() for lp in eng.pages for t in (lp.k, lp.v, lp.k_scale, lp.v_scale)]
    b = eng.submit(list(prompt), max_new_tokens=3)
    eng._admit()
    owned = set(int(p) for p in eng.alloc.tables[b.slot, : eng.alloc.allocated[b.slot]])
    eng._prefill_advance_group()  # the hot chunk: rows 96..99, page 3
    after = [t for lp in eng.pages for t in (lp.k, lp.v, lp.k_scale, lp.v_scale)]
    for old, new in zip(pool, after):
        changed = {int(p) for p in torch.nonzero((old != new).flatten(2).any(-1).any(0)).flatten()}
        assert changed <= owned


def test_paged_burst_matches_per_step(params):
    prompts = [[3, 17, 42, 99, 7], [1, 2, 3]]
    kw = dict(cache_dtype=torch.int8, cache_backend="paged", page_size=64)
    ref_eng, ref = _run(params, prompts, 9, **kw)
    eng, got = _run(params, prompts, 9, burst=4, **kw)
    assert [r.output for r in got] == [r.output for r in ref]
    assert eng.stats == ref_eng.stats and eng._backend.stats["bursts"] >= 2
    # One prefill group and its eager step, then bursts of 4 and 3 steps.
    assert eng._backend.stats["bursts"] == 2 and eng.timings["eager_steps"] == 1
    assert int(eng.alloc.allocated.sum()) == 0 and int(eng.alloc.lengths.sum()) == 0
    # An EOS mid-burst stops its request on the device.
    eos = ref[0].output[3]
    eng = Engine(params, CFG, num_slots=2, max_len=256, **kw)
    a = eng.submit(prompts[0], max_new_tokens=9, eos_id=eos)
    b = eng.submit(prompts[1], max_new_tokens=9)
    eng.run_to_completion(decode_burst=4)
    assert a.output == ref[0].output[: ref[0].output.index(eos) + 1]
    assert b.output == ref[1].output


def test_paged_burst_mixed_with_admission(params):
    prompts = [[(5 * i + j) % 250 + 1 for j in range(10)] for i in range(5)]
    eng, reqs = _run(params, prompts, 7, burst=4, max_len=128, cache_dtype=torch.int8,
                     cache_backend="paged", page_size=64, num_pages=4)
    assert all(r.done and len(r.output) == 7 for r in reqs)
    assert int(eng.alloc.allocated.sum()) == 0


def test_inactive_slot_writes_go_to_the_trash_page(params):
    """A released slot's table row may name pages another sequence owns
    now: the decode step sends its lane to the trash page, never there."""
    eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=torch.int8,
                 cache_backend="paged", page_size=64)
    ra = eng.submit([3, 17, 42, 99, 7], max_new_tokens=3)
    rb = eng.submit([9, 1, 2, 7, 5, 11], max_new_tokens=12)
    while not ra.done:
        eng.step()
    assert not rb.done
    live_page = int(eng.alloc.tables[rb.slot, 0])
    eng.alloc.tables[ra.slot, :] = live_page  # the dead lane aliases a live page
    before = eng.pages[0].k[:, live_page, 0].clone()
    trash = eng.pages[0].k[:, eng._backend._trash_page].clone()
    for _ in range(3):
        eng.step()
    assert torch.equal(eng.pages[0].k[:, live_page, 0], before)
    assert not torch.equal(eng.pages[0].k[:, eng._backend._trash_page], trash)


def test_cancel_mid_chunked_prefill_frees_pages(params):
    eng = _prefix_engine(params)
    free0 = eng.alloc.free_pages
    r = eng.submit(list(range(1, 150)), max_new_tokens=4)
    eng.step()
    assert 0 < r.prefill_pos < len(r.prompt)
    eng.cancel(r)
    assert r.done and eng.alloc.free_pages == free0 and eng.free_slots == [1, 0]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(checks, "cuda_available", lambda: True)
    assert checks.default_device() == torch.device("cuda")
    assert checks.default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(checks, "cuda_available", lambda: False)
    cfg = tl.tiny()
    for make in (
        lambda: kvc.init_cache(1, 2, 8, 64),
        lambda: pgc.init_layer_pages(2, 4, 16, 64),
        lambda: SlotsBackend(cfg, num_slots=1, max_len=8),
        lambda: PagedBackend(cfg, num_slots=1, max_len=32, page_size=16),
        lambda: convert.params_from_numpy({"layers": [{}, {}], "embed": np.zeros(2)}, cfg),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
