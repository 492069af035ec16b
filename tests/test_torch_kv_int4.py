"""int4 and e4m3 KV caches against the JAX package, on the CPU.

- The int4 quantizers (``quant.quantize_int4_values``, ``pack_int4``,
  ``unpack_int4``, ``dynamically_quantize_int4``): codes equal bit for bit,
  scales equal (both eager: amax / 7 in float32); the weight packing of
  ``models/quantized`` is the same split-halves layout.
- Slot-cache appends and page writes into int4 and e4m3 containers against
  JAX's jitted ``kv_cache.append`` / ``paged_cache.write_tokens``: codes
  equal, scales to two float32 ulps (XLA turns amax / qmax into a product
  with the reciprocal under jit, ROADMAP queue 3's caveats).
- K4's and K10's plain versions over int4 and e4m3 caches, with bf16,
  float32 and float16 queries, against JAX's kernels in interpret mode
  (K10: ``use_dma=True``, the DMA path it ports).  Tolerance as
  tests/test_torch_decode.py and tests/test_torch_paged.py: both round the
  unnormalized P to bf16 and return bf16, the JAX kernels' running maximum
  moves block by block, and JAX multiplies float32 queries unrounded where
  the port rounds them to bf16 (as its kernels take them): max |diff| <=
  1/32 and RMSE < 1e-2; empty slots exactly zero.
- A paged decode step over int4 and e4m3 pages against JAX's
  ``PagedBackend`` (its per-lane nibble writes, backends.py:1134-1207):
  logits within the decode-step bar, and every page byte but the written
  tokens' as it was on both sides.
- ``Engine(kv_int4=True)`` and e4m3 caches on both backends against JAX's
  engine: first tokens equal (one prefill forward each, or chunked prefill
  over the packed prefix), counters equal (tests/test_engine.py:438-482).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jqz
from quantumattention_tpu.ops import quant as jq
from quantumattention_tpu.ops.decode import decode_attention as jdecode
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
from quantumattention_tpu.serving import kv_cache as jkvc
from quantumattention_tpu.serving import paged_cache as jpgc
from quantumattention_tpu.serving.backends import PagedBackend as JPaged
from quantumattention_tpu.serving.engine import Engine as JEngine
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.models import quantized as tqz
from quantumattention_tpu_torch.ops import qmm, quant as tq
from quantumattention_tpu_torch.ops.decode import decode_attention as tdecode
from quantumattention_tpu_torch.ops.paged import paged_decode_attention as tpaged
from quantumattention_tpu_torch.serving import kv_cache as tkvc
from quantumattention_tpu_torch.serving import paged_cache as tpgc
from quantumattention_tpu_torch.serving.backends import PagedBackend
from quantumattention_tpu_torch.serving.engine import Engine

ATOL = 1.0 / 32
RMSE_BAR = 1e-2
STEP_BAR = 2e-2
SCALE_RTOL = 2.4e-7  # two float32 ulps
E4M3 = torch.float8_e4m3fn


def _j(t: torch.Tensor):
    """The same values as a jax array of the matching type."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8, torch.int32: jnp.int32,
           torch.float32: jnp.float32, torch.float16: jnp.float16, E4M3: jnp.float8_e4m3fn}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rng_t(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# Quantizers and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((3, 5, 64), -1), ((2, 8, 16, 24), 2), ((6, 7), 0)])
def test_int4_quantizers_match_jax(shape, axis):
    x = _rng_t(np.random.default_rng(len(shape)), shape) * 3.0
    tv, ts = tq.quantize_int4_values(x, reduction_dim=-1)
    jv, js = jq.quantize_int4_values(jnp.asarray(x.numpy()), reduction_dim=-1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tv.abs().max()) <= 7
    tp = tq.pack_int4(tv, axis=axis)
    jp = jq.pack_int4(jv, axis=axis)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tq.unpack_int4(tp, axis=axis).numpy(), tv.numpy())
    np.testing.assert_array_equal(tq.unpack_int4(tp, torch.float32, axis=axis).numpy(),
                                  _f32(jq.unpack_int4(jp, jnp.float32, axis=axis)))
    if axis == -1:
        tpk, tsk = tq.dynamically_quantize_int4(x, reduction_dim=-1)
        jpk, jsk = jq.dynamically_quantize_int4(jnp.asarray(x.numpy()), reduction_dim=-1)
        np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
        np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros((3, 5), dtype=torch.int8), axis=0)
    with pytest.raises(ValueError, match="reduction_dim"):
        tq.dynamically_quantize_int4(x, reduction_dim=0)


def test_weight_packing_is_the_split_halves_layout():
    """``models/quantized``'s 256-row-block packing (and ``qmm.unpack_int4``)
    is ``quant.pack_int4`` along the rows of each block, equal to JAX's."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(-8, 8, (512, 256)).astype(np.int8))
    packed = tqz.pack_int4_rows(q)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jqz.pack_int4_rows(jnp.asarray(q.numpy()))))
    blocks = tq.pack_int4(q.reshape(2, 256, 256), axis=1).reshape(256, 256)
    assert torch.equal(packed, blocks)
    assert torch.equal(qmm.unpack_int4(packed), q.to(torch.int32))


# ---------------------------------------------------------------------------
# Cache and page writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 24])
@pytest.mark.parametrize("kind", ["int4", "e4m3"])
def test_slot_cache_append_matches_jax(kind, width):
    hkv, d, smax = 2, 64, 64
    int4 = kind == "int4"
    tdt, jdt = (torch.int8, jnp.int8) if int4 else (E4M3, jnp.float8_e4m3fn)
    tc = tkvc.init_cache(3, hkv, smax, d, tdt, int4=int4, device="cpu")
    jc = jkvc.init_cache(3, hkv, smax, d, jdt, int4=int4)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) and tc.k.dtype == tdt
    rng = np.random.default_rng(width + int4)
    for step in range(2):
        k = rng.standard_normal((2, hkv, width, d)).astype(np.float32)
        v = rng.standard_normal((2, hkv, width, d)).astype(np.float32)
        slots = np.array([2, 0], np.int32)
        offsets = np.array([3 + step * width, step * width], np.int32)
        n_valid = np.array([width, width - 1 if width > 1 else 0], np.int32)
        tkvc.append(tc, torch.from_numpy(slots).long(), torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(offsets).long(), torch.from_numpy(n_valid))
        jc = jkvc.append(jc, jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(offsets), jnp.asarray(n_valid))
    for mine, theirs in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(mine.float().numpy(), _f32(theirs))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=SCALE_RTOL, atol=0)
    with pytest.raises(ValueError, match="int8 container"):
        tkvc.init_cache(1, hkv, smax, d, E4M3, int4=True, device="cpu")


@pytest.mark.parametrize("kind,ps,offset,t", [
    ("int4", 32, 0, 64), ("int4", 32, 5, 40), ("int4", 8, 3, 13), ("e4m3", 32, 7, 50),
    ("e4m3", 8, 0, 24),
])
def test_write_tokens_matches_jax(kind, ps, offset, t):
    """Page writes at any offset, across pages: int4 by read-modify-write of
    the page's bytes (paged_cache.py:135-180), so the nibbles of tokens
    already in a page survive."""
    hkv, d, n_pages = 2, 64, 10
    int4 = kind == "int4"
    tdt, jdt = (torch.int8, jnp.int8) if int4 else (E4M3, jnp.float8_e4m3fn)
    tp = tpgc.init_layer_pages(hkv, n_pages, ps, d, tdt, int4=int4, device="cpu")
    jp = jpgc.init_layer_pages(hkv, n_pages, ps, d, jdt, int4=int4)
    assert tuple(tp.k.shape) == tuple(jp.k.shape) and tuple(tp.k_scale.shape) == (hkv, n_pages, ps)
    rng = np.random.default_rng(ps + t)
    ids = [7, 2, 9, 4, 0, 5]
    for off, n in ((offset, t), (0, ps // 2)):  # the second write lands beside the first
        k = rng.standard_normal((hkv, n, d)).astype(np.float32)
        v = rng.standard_normal((hkv, n, d)).astype(np.float32)
        pages = ids if off == offset else ids[-1:] + ids[:-1]
        tpgc.write_tokens(tp, pages, off, torch.from_numpy(k), torch.from_numpy(v))
        jp = jpgc.write_tokens(jp, jnp.asarray(pages, jnp.int32), off, jnp.asarray(k), jnp.asarray(v))
    for mine, theirs in ((tp.k, jp.k), (tp.v, jp.v)):
        np.testing.assert_array_equal(mine.float().numpy(), _f32(theirs))
    np.testing.assert_allclose(tp.k_scale.numpy(), np.asarray(jp.k_scale), rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(tp.v_scale.numpy(), np.asarray(jp.v_scale), rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("ps", [8, 32])
def test_write_lanes_equals_write_tokens(ps):
    """The decode step's per-lane writes (nibble writes for int4) leave the
    same pages as ``write_tokens`` one token at a time."""
    hkv, d, n_pages = 2, 64, 6
    rng = np.random.default_rng(ps)
    for int4, dt in ((True, torch.int8), (False, E4M3), (False, torch.int8)):
        a = tpgc.init_layer_pages(hkv, n_pages, ps, d, dt, int4=int4, device="cpu")
        b = tpgc.init_layer_pages(hkv, n_pages, ps, d, dt, int4=int4, device="cpu")
        tpgc.write_tokens(a, [1, 3], 0, _rng_t(rng, (hkv, 2 * ps, d)), _rng_t(rng, (hkv, 2 * ps, d)))
        for x, y in ((b.k, a.k), (b.v, a.v), (b.k_scale, a.k_scale), (b.v_scale, a.v_scale)):
            x.copy_(y)
        page = torch.tensor([1, 3, 4, 0])
        off = torch.tensor([ps - 1, ps // 2, 0, ps // 2 - 1])
        k, v = _rng_t(rng, (4, hkv, d)), _rng_t(rng, (4, hkv, d))
        tpgc.write_lanes(a, page, off, k, v)
        for i in range(4):
            tpgc.write_tokens(b, [int(page[i])], int(off[i]), k[i][:, None], v[i][:, None])
        for x, y in ((a.k, b.k), (a.v, b.v), (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# K4 and K10 (plain versions) against JAX's kernels
# ---------------------------------------------------------------------------


def _check(got, want, empty):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(_f32(want))
    for i in empty:
        assert torch.equal(got[i], torch.zeros_like(got[i]))
    diff = got.float() - want
    assert float(diff.abs().max()) <= ATOL
    assert float(diff.pow(2).mean().sqrt()) < RMSE_BAR


QUERY_TYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


@pytest.mark.parametrize("qtype", ["bf16", "f32", "f16"])
@pytest.mark.parametrize("kind", ["int4", "e4m3"])
def test_decode_plain_matches_jax(kind, qtype):
    b, hq, hkv, smax, d = 3, 8, 2, 256, 64
    lengths = [0, 37, 200]
    rng = np.random.default_rng(11)
    q = _rng_t(rng, (b, hq, d)).to(QUERY_TYPES[qtype])
    k, v = _rng_t(rng, (b, hkv, smax, d)), _rng_t(rng, (b, hkv, smax, d))
    if kind == "int4":
        (kc, ks), (vc, vs) = (tq.dynamically_quantize_int4(x, reduction_dim=-1) for x in (k, v))
    else:
        (kc, ks), (vc, vs) = (tq.dynamically_quantize_fp8(x, reduction_dim=-1) for x in (k, v))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = tdecode(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    want = jdecode(_j(q), _j(kc), _j(vc), jnp.asarray(lengths, jnp.int32), k_scale=_j(ks),
                   v_scale=_j(vs), interpret=True)
    _check(got, want, empty=[0])


def test_decode_refuses_8bit_queries_as_jax():
    q = torch.zeros((1, 2, 64), dtype=torch.int8)
    kc = torch.zeros((1, 1, 16, 32), dtype=torch.int8)
    s = torch.ones((1, 1, 16))
    with pytest.raises(ValueError, match="float queries"):
        tdecode(q, kc, kc, torch.tensor([3], dtype=torch.int32), k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="float queries"):
        jdecode(jnp.zeros((1, 2, 64), jnp.int8), jnp.zeros((1, 1, 16, 32), jnp.int8),
                jnp.zeros((1, 1, 16, 32), jnp.int8), jnp.asarray([3]), k_scale=jnp.ones((1, 1, 16)),
                v_scale=jnp.ones((1, 1, 16)), interpret=True)
    with pytest.raises(ValueError, match="int8 container"):
        tdecode(q.to(torch.bfloat16), kc.to(E4M3), kc.to(E4M3), torch.tensor([3], dtype=torch.int32),
                k_scale=s, v_scale=s)


def paged_inputs(seed, b, hkv, group, ps, pps, d, kind, lengths, qtype=torch.bfloat16):
    """Random pages of `kind` (int8, e4m3, int4 token-packed, bf16) quantized
    by the port's quantizers, a shuffled table over a larger pool, and q: the
    port's tensors and JAX's arrays of the same values."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    kf, vf = _rng_t(rng, (hkv, num_pages, ps, d)), _rng_t(rng, (hkv, num_pages, ps, d))
    table = torch.from_numpy(rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32))
    q = _rng_t(rng, (b, hkv * group, d)).to(qtype)
    ks = vs = None
    if kind == "int4":
        (k, ks), (v, vs) = (tq.quantize_int4_values(x, reduction_dim=-1) for x in (kf, vf))
        k, v = tq.pack_int4(k, axis=2), tq.pack_int4(v, axis=2)
    elif kind == "int8":
        (k, ks), (v, vs) = (tq.dynamically_quantize_int8(x, reduction_dim=-1) for x in (kf, vf))
    elif kind == "e4m3":
        (k, ks), (v, vs) = (tq.dynamically_quantize_fp8(x, reduction_dim=-1) for x in (kf, vf))
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32)
    tin = (q, k, v, ks, vs, lens, table)
    jin = tuple(None if x is None else _j(x) for x in tin)
    return tin, jin


@pytest.mark.parametrize("qtype", ["bf16", "f32"])
@pytest.mark.parametrize("kind,ps", [("int4", 32), ("int4", 64), ("e4m3", 32), ("e4m3", 128)])
def test_paged_plain_matches_jax_dma_kernel(kind, ps, qtype):
    b, hkv, group, pps, d = 3, 2, 4, 4, 64
    tin, jin = paged_inputs(ps, b, hkv, group, ps, pps, d, kind, [pps * ps, 0, ps + 7],
                            QUERY_TYPES[qtype])
    q, k, v, ks, vs, lens, table = tin
    got = tpaged(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs, pages_per_block=2)
    jq_, jk, jv, jks, jvs, jl_, jt = jin
    want = jpaged(jq_, jk, jv, jl_, jt, k_scale_pages=jks, v_scale_pages=jvs, pages_per_block=2,
                  use_dma=True, interpret=True)
    _check(got, want, empty=[1])


# ---------------------------------------------------------------------------
# The paged decode step and the engines
# ---------------------------------------------------------------------------

SHAPES = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
              num_q_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.std(b))


@pytest.mark.parametrize("kind", ["int4", "e4m3"])
def test_paged_decode_step_matches_jax(kind):
    """One decode step over random int4 or e4m3 pages on both backends (the
    bf16 tree): logits at the decode-step bar; the pages after the step
    equal JAX's everywhere but at the tokens just written (their codes may
    differ by a rounding of k/v), so a nibble write leaves its partner
    token's nibble as it was."""
    jcfg, tcfg = jl.LlamaConfig(**SHAPES), tl.LlamaConfig(**SHAPES)
    jtree = jl.init_params(jax.random.PRNGKey(1), jcfg)
    ttree = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), tcfg, device="cpu")
    int4 = kind == "int4"
    tdt, jdt = (torch.int8, jnp.int8) if int4 else (E4M3, jnp.float8_e4m3fn)
    slots, ps, max_len = 4, 32, 128
    tp = PagedBackend(tcfg, num_slots=slots, max_len=max_len, cache_dtype=tdt, kv_int4=int4,
                      page_size=ps, device="cpu")
    jp = JPaged(jcfg, num_slots=slots, max_len=max_len, cache_dtype=jdt, kv_int4=int4, page_size=ps)
    rng = np.random.default_rng(4)
    jpages = []
    for lp in tp.pages:
        if int4:
            vals = [torch.from_numpy(rng.integers(-128, 128, lp.k.shape).astype(np.int8)) for _ in range(2)]
        else:
            vals = [(_rng_t(rng, lp.k.shape) * 100).clamp(-448, 448).to(E4M3) for _ in range(2)]
        scs = [torch.from_numpy((rng.random(lp.k_scale.shape) * 0.02 + 0.005).astype(np.float32))
               for _ in range(2)]
        for dst, src in zip((lp.k, lp.v, lp.k_scale, lp.v_scale), vals + scs):
            dst.copy_(src)
        jpages.append(jpgc.LayerPages(*(_j(x) for x in vals + scs)))
    jp.pages = jpages
    lengths = np.array([37, 0, 100, 5], np.int32)
    for be in (tp, jp):
        for s, n in enumerate(lengths):
            be.alloc.allocate(s, int(n) + 8, ps)
        be.alloc.lengths[:] = lengths
    np.testing.assert_array_equal(tp.alloc.tables, jp.alloc.tables)
    tokens = np.array([7, 0, 99, 201], np.int32)
    active = np.array([True, False, True, True])
    got = tp.decode(ttree, tokens, active, [0, 2, 3]).numpy()
    with jax.disable_jit():
        jp.pages, want = jp._decode_step_impl(
            jtree, jp.pages, jnp.asarray(tokens), jnp.asarray(jp.alloc.tables),
            jnp.asarray(jp.alloc.lengths), jnp.asarray(active))
    want = np.asarray(want)
    assert np.isfinite(got).all() and _rel(got[active], want[active]) < STEP_BAR
    np.testing.assert_array_equal(tp.host_lengths(), lengths + active)
    for lp, jlp in zip(tp.pages, jp.pages):
        for mine, theirs in ((lp.k, jlp.k), (lp.v, jlp.v)):
            a, b = mine, torch.from_numpy(_f32(theirs))
            if int4:  # compare tokens, not bytes
                a, b = tq.unpack_int4(a, axis=2), tq.unpack_int4(b.to(torch.int8), axis=2)
            same = (a.float() == b.float()).all(dim=3).all(dim=0)
            for s in np.flatnonzero(active):
                page, row = tp.alloc.tables[s, lengths[s] // ps], lengths[s] % ps
                same[page, row] = True
            same[tp._trash_page] = True
            assert bool(same.all())


CFG = tl.tiny(attention_impl="bf16")
PROMPT_SETS = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(3, 80))]


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jax.random.PRNGKey(0), jl.tiny())


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), CFG, device="cpu")


@pytest.mark.parametrize("backend", ["slots", "paged"])
@pytest.mark.parametrize("kind", ["int4", "e4m3"])
def test_engine_matches_jax_engine(jax_params, params, kind, backend):
    """kv_int4 (or an e4m3 cache) on either backend, with chunked prefill
    over the packed prefix: first tokens and counters equal to JAX's, every
    request done (JAX's CPU paged flow is nondeterministic and an untrained
    model's later tokens sit on near-ties: only invariants are compared)."""
    int4 = kind == "int4"
    kw = dict(num_slots=2, max_len=256, kv_int4=int4, prefill_chunk=64)
    if backend == "paged":
        kw.update(cache_backend="paged", page_size=32)
    je = JEngine(jax_params, jl.tiny(attention_impl="bf16"),
                 cache_dtype=jnp.int8 if int4 else jnp.float8_e4m3fn, **kw)
    jr = [je.submit(p, max_new_tokens=4) for p in PROMPT_SETS]
    je.run_to_completion()
    te = Engine(params, CFG, cache_dtype=torch.int8 if int4 else E4M3, **kw)
    tr = [te.submit(p, max_new_tokens=4) for p in PROMPT_SETS]
    te.run_to_completion()
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == 4
        assert b.output[0] == a.output[0]
    for key in ("prefill_tokens", "prefill_forwards", "generated_tokens"):
        assert te.stats[key] == je.stats[key], key
    store = te.pages[0].k if backend == "paged" else te.caches[0].k
    if int4:
        assert store.dtype == torch.int8
        assert store.shape[2 if backend == "paged" else 3] == (32 if backend == "paged" else CFG.head_dim) // 2
    else:
        assert store.dtype == E4M3


@pytest.mark.parametrize("kind", ["int4", "e4m3", "int8"])
def test_paged_engine_matches_slots_engine(params, kind):
    """The same cache type on both backends of the port: equal first tokens,
    and the JAX suite's ``agree >= n - 1`` after (tests/test_engine.py)."""
    dt = E4M3 if kind == "e4m3" else torch.int8
    prompts = [[3, 17, 42, 99, 7], list(range(3, 60))]
    outs = []
    for extra in ({}, {"cache_backend": "paged", "page_size": 64}):
        eng = Engine(params, CFG, num_slots=2, max_len=256, cache_dtype=dt,
                     kv_int4=kind == "int4", **extra)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        outs.append([r.output for r in reqs])
    for a, b in zip(*outs):
        assert len(b) == 6 and b[0] == a[0]
        assert sum(x == y for x, y in zip(a, b)) >= 5
