"""The paged slice's kernels and cache against the JAX package, on the CPU.

- K10's plain version (``ops/paged.paged_decode_attention`` on CPU
  tensors) against JAX ``paged_decode_attention(..., use_dma=True,
  interpret=True)``, the Pallas kernel's DMA path whose math K10 ports (the
  interpret default takes the gathered reference instead, tests/test_paged.py
  does the same).  Tolerance: both dequantize K/V per element to bf16 and
  round the unnormalized P to bf16; the JAX kernel does it per 4-page block
  of an online softmax, the plain version once, so outputs differ by bf16
  ulps: RMSE < 1e-2 (the repository's bar, also held against the fp32
  oracle on the dequantized rows), max |diff| <= 1/32, empty slots exactly
  zero.
- Validation messages and the not-ported modes.
- ``hash_pages``, ``PageAllocator`` (the op sequences of
  tests/test_prefix_cache.py:20-130) and ``write_tokens``: equal to JAX's,
  bit for bit.
- K1's plain version with ``q_offset`` against JAX ``flash_attention(
  q_offset=...)`` in interpret mode, at the tolerance of
  tests/test_torch_flash.py (both bf16 outputs; the JAX kernel rounds P to
  bf16 where the plain version keeps fp32: ATOL 1/16, RMSE < 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.ops.flash import flash_attention as jflash
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
from quantumattention_tpu.serving import paged_cache as jpgc
from quantumattention_tpu_torch.ops import quant
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash
from quantumattention_tpu_torch.ops.paged import paged_decode_attention
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.serving import paged_cache as pgc

RMSE_BAR = 1e-2
ATOL = 1.0 / 32
K1_ATOL = 1.0 / 16
K1_RMSE = 2e-3


def _bf16(a: np.ndarray):
    """The same bf16 values as a torch tensor and a jax array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _paged_inputs(seed, b, hkv, group, ps, pps, d, kind, lengths):
    """Random pages, a shuffled table over a larger pool, and q; int8 pages
    quantized by the port's quantizer (equal to JAX's, tests/test_torch_quant.py)."""
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 3
    kf = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    vf = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    table = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    qt, qj = _bf16(rng.standard_normal((b, hkv * group, d)))
    if kind == "int8":
        k8, ks = quant.dynamically_quantize_int8(torch.from_numpy(kf), reduction_dim=-1)
        v8, vs = quant.dynamically_quantize_int8(torch.from_numpy(vf), reduction_dim=-1)
        tk = (k8, v8, ks, vs)
        jk = tuple(jnp.asarray(x.numpy()) for x in tk)
    else:
        (k_t, k_j), (v_t, v_j) = _bf16(kf), _bf16(vf)
        tk, jk = (k_t, v_t, None, None), (k_j, v_j, None, None)
    lens = np.asarray(lengths, np.int32)
    return (qt, *tk, torch.from_numpy(lens), torch.from_numpy(table)), (
        qj, *jk, jnp.asarray(lens), jnp.asarray(table))


def _oracle(q, k, v, ks, vs, lengths, table):
    """fp32 SDPA over each sequence's dequantized rows, zeros for empty."""
    out = torch.zeros(q.shape, dtype=torch.float32)
    for i, n in enumerate(lengths.tolist()):
        if not n:
            continue
        ids = table[i].long()

        def rows(x, s):
            g = x[:, ids].float()
            if s is not None:
                g = g * s[:, ids][..., None]
            return g.reshape(x.shape[0], -1, x.shape[3])[:, :n]

        out[i] = sdpa_reference(q[i][None, :, None].float(), rows(k, ks)[None], rows(v, vs)[None],
                                out_dtype=torch.float32)[0, :, 0]
    return out


# (kind, group, page_size, pages_per_block): every page type, group 1 and
# 4, page sizes 32/64/128 and blocks of 1/2/4 pages, each value at least twice.
PAGED_CASES = [
    ("bf16", 1, 32, 1), ("bf16", 4, 64, 2), ("bf16", 4, 128, 4), ("bf16", 1, 128, 2),
    ("int8", 1, 128, 1), ("int8", 4, 32, 4), ("int8", 4, 64, 2), ("int8", 1, 64, 4),
]


@pytest.mark.parametrize("kind,group,ps,ppb", PAGED_CASES)
def test_paged_plain_matches_jax_dma_kernel(kind, group, ps, ppb):
    b, hkv, pps, d = 3, 2, 4, 64
    full = pps * ps
    tin, jin = _paged_inputs(ps + group, b, hkv, group, ps, pps, d, kind, [full, 0, ps + 7])
    q, k, v, ks, vs, lengths, table = tin
    got = paged_decode_attention(q, k, v, lengths, table, k_scale_pages=ks, v_scale_pages=vs,
                                 pages_per_block=ppb)
    jq_, jk, jv, jks, jvs, jl, jt = jin
    want = jpaged(jq_, jk, jv, jl, jt, k_scale_pages=jks, v_scale_pages=jvs,
                  pages_per_block=ppb, use_dma=True, interpret=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv * group, d)
    assert torch.equal(got[1], torch.zeros_like(got[1]))  # the empty slot
    diff = got.float() - want
    assert float(diff.abs().max()) <= ATOL
    assert float(diff.pow(2).mean().sqrt()) < RMSE_BAR
    oracle = _oracle(q, k, v, ks, vs, lengths, table)
    assert float((got.float() - oracle).pow(2).mean().sqrt()) < RMSE_BAR


def test_paged_never_reads_table_entries_past_the_pages():
    """Entries past a sequence's pages may be anything (here out of range):
    they are not read, and the result equals a table with valid entries."""
    tin, _ = _paged_inputs(3, 2, 2, 4, 32, 4, 64, "int8", [40, 0])
    q, k, v, ks, vs, lengths, table = tin
    want = paged_decode_attention(q, k, v, lengths, table, k_scale_pages=ks, v_scale_pages=vs)
    bad = table.clone()
    bad[0, 2:] = 10_000
    bad[1, :] = -5
    got = paged_decode_attention(q, k, v, lengths, bad, k_scale_pages=ks, v_scale_pages=vs)
    assert torch.equal(got, want)


def test_paged_folded_scale_layout_equals_flat():
    """JAX's folded (Hkv, P, ps/128, 128) scale pages are taken as a view of
    the flat (Hkv, P, ps) ones, and the result is held against JAX's DMA
    kernel on its folded arrays (page size 256)."""
    b, hkv, group, ps, pps, d = 2, 2, 4, 256, 2, 64
    tin, jin = _paged_inputs(7, b, hkv, group, ps, pps, d, "int8", [300, 512])
    q, k, v, ks, vs, lengths, table = tin
    fold = lambda s: s.reshape(s.shape[0], s.shape[1], ps // 128, 128)  # noqa: E731
    flat = paged_decode_attention(q, k, v, lengths, table, k_scale_pages=ks, v_scale_pages=vs,
                                  pages_per_block=2)
    folded = paged_decode_attention(q, k, v, lengths, table, k_scale_pages=fold(ks),
                                    v_scale_pages=fold(vs), pages_per_block=2)
    assert torch.equal(flat, folded)
    jq_, jk, jv, jks, jvs, jl, jt = jin
    want = jpaged(jq_, jk, jv, jl, jt, k_scale_pages=fold(jks), v_scale_pages=fold(jvs),
                  pages_per_block=2, use_dma=True, interpret=True)
    diff = folded.float() - torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert float(diff.abs().max()) <= ATOL and float(diff.pow(2).mean().sqrt()) < RMSE_BAR


def _raises_like_jax(exc, match, targs, jargs, **kw):
    with pytest.raises(exc, match=match):
        paged_decode_attention(*targs, **kw)
    jkw = {key: (jnp.asarray(val.numpy()) if isinstance(val, torch.Tensor) else val)
           for key, val in kw.items()}
    with pytest.raises(exc, match=match):
        jpaged(*jargs, **jkw, interpret=True)


def test_paged_validation_matches_jax():
    """The JAX wrapper's ValueErrors and messages (paged.py:459-545)."""
    targs = (torch.zeros((1, 4, 64), dtype=torch.bfloat16), torch.zeros((2, 8, 64, 64), dtype=torch.int8),
             torch.zeros((2, 8, 64, 64), dtype=torch.int8), torch.tensor([5], dtype=torch.int32),
             torch.zeros((1, 4), dtype=torch.int32))
    jargs = tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
                  else jnp.asarray(t.numpy()) for t in targs)
    good, bad = torch.ones((2, 8, 64)), torch.ones((2, 8, 48))
    _raises_like_jax(ValueError, "require scale pages", targs, jargs)
    _raises_like_jax(ValueError, "go together", targs, jargs, k_scale_pages=good)
    _raises_like_jax(ValueError, "token rows", targs, jargs, k_scale_pages=bad, v_scale_pages=bad)
    _raises_like_jax(ValueError, "disagree", targs, jargs, k_scale_pages=good,
                     v_scale_pages=torch.ones((2, 8, 128)))
    _raises_like_jax(ValueError, "128-lane minor", targs, jargs,
                     k_scale_pages=torch.ones((2, 8, 1, 64)), v_scale_pages=torch.ones((2, 8, 1, 64)))
    _raises_like_jax(ValueError, "multiple", targs, jargs, k_scale_pages=good, v_scale_pages=good,
                     pages_per_block=3)
    _raises_like_jax(ValueError, "right", targs, jargs, k_scale_pages=good, v_scale_pages=good,
                     window=(8, 2))
    odd = (targs[0][:, :3],) + targs[1:]
    jodd = (jargs[0][:, :3],) + jargs[1:]
    _raises_like_jax(ValueError, "divisible", odd, jodd, k_scale_pages=good, v_scale_pages=good)


def test_paged_not_ported_modes_raise():
    """The side buffer: valid in JAX, NotImplementedError naming ROADMAP.
    (Token-packed int4 pages are ported: tests/test_torch_kv_int4.py holds
    them against JAX; so is the multi-query q, tests/test_torch_verify.py,
    and the window: the 4-D call and the windowed call that used to be
    refused now run, the latter held here to JAX's DMA kernel.)"""
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16)
    kp = torch.zeros((2, 8, 32, 64), dtype=torch.int8)
    lengths, table = torch.tensor([5], dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32)
    s32 = torch.ones((2, 8, 32))
    one = paged_decode_attention(q[:, :, None], kp, kp, lengths, table, k_scale_pages=s32,
                                 v_scale_pages=s32)
    assert one.shape == (1, 4, 1, 64)
    assert torch.equal(one[:, :, 0], paged_decode_attention(q, kp, kp, lengths, table,
                                                            k_scale_pages=s32, v_scale_pages=s32))
    tin, jin = _paged_inputs(16, 2, 2, 2, 32, 4, 64, "int8", [100, 0])
    tq_, tk, tv, tks, tvs, tl_, tt = tin
    jq_, jk, jv, jks, jvs, jl_, jt = jin
    got = paged_decode_attention(tq_, tk, tv, tl_, tt, k_scale_pages=tks, v_scale_pages=tvs,
                                 pages_per_block=2, window=(16, 0))
    want = jpaged(jq_, jk, jv, jl_, jt, k_scale_pages=jks, v_scale_pages=jvs, pages_per_block=2,
                  window=(16, 0), use_dma=True, interpret=True)
    assert float((got.float() - torch.from_numpy(np.array(want.astype(jnp.float32)))).abs().max()) <= ATOL
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_decode_attention(q, kp, kp, lengths, table, k_scale_pages=s32, v_scale_pages=s32,
                               side={"k": kp})


def test_hash_pages_equals_jax():
    ps = 16
    for prompt in (list(range(40)), [99] + list(range(1, 40)), list(range(16)) + [99] + list(range(17, 40)),
                   [1, 2, 3], [5] * 64):
        assert pgc.hash_pages(prompt, ps) == jpgc.hash_pages(prompt, ps)


def _same_state(a, b):
    np.testing.assert_array_equal(a.tables, b.tables)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.allocated, b.allocated)
    assert a.free == b.free and a.cache == b.cache and a.page_hash == b.page_hash
    assert a.refs == b.refs and list(a.idle) == list(b.idle)


def _ops_register_adopt_release(a, h):
    hashes = h(list(range(48)), 16)
    yield a.allocate(0, 48, 16)
    yield a.register(0, hashes)
    yield a.match_prefix(hashes)
    m = a.match_prefix(hashes[:2])
    yield a.adopt(1, m)
    yield a.allocate(1, 48, 16)
    yield a.release(0)
    yield a.match_prefix(hashes[:2])
    yield a.release(1)
    yield a.match_prefix(hashes)


def _ops_lru_eviction(a, h):
    h1 = h([1] * 32, 16)
    yield a.allocate(0, 32, 16)
    yield a.register(0, h1)
    yield a.release(0)
    yield (a.evictable_pages, a.free_pages, a.can_fit(64, 16))
    yield a.allocate(1, 64, 16)
    yield a.match_prefix(h1)
    yield a.release(1)
    yield a.free_pages


def _ops_first_writer_wins(a, h):
    hh = h([5] * 16, 16)
    yield a.allocate(0, 16, 16)
    yield a.allocate(1, 16, 16)
    yield a.register(0, hh)
    yield a.register(1, hh)
    yield a.match_prefix(hh)
    yield a.release(1)
    yield a.allocate(2, 40, 16)
    yield a.release(0)


@pytest.mark.parametrize("ops,size", [
    (_ops_register_adopt_release, (10, 4, 6)),
    (_ops_lru_eviction, (4, 2, 4)),
    (_ops_first_writer_wins, (10, 4, 6)),
])
def test_page_allocator_equals_jax(ops, size):
    """The same op sequence on both allocators: equal results and equal
    tables, free lists, refcounts and LRU pools after every op."""
    a, b = pgc.PageAllocator(*size), jpgc.PageAllocator(*size)
    for x, y in zip(ops(a, pgc.hash_pages), ops(b, jpgc.hash_pages)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
        _same_state(a, b)


def test_page_allocator_errors():
    a = pgc.PageAllocator(4, 2, 4)
    a.allocate(0, 16, 16)
    with pytest.raises(ValueError, match="empty"):
        a.adopt(0, [3])
    with pytest.raises(ValueError, match="pages_per_seq"):
        a.allocate(1, 80, 16)
    a.allocate(1, 48, 16)
    with pytest.raises(MemoryError):
        a._take_free()


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_write_tokens_equals_jax(kind):
    """A 70-token write from offset 5 of the first of three 32-token pages,
    in place, equal to JAX's write: the values bit for bit; the fp32 scales
    to one ulp, because JAX's ``write_tokens`` is jitted and XLA's CPU
    compiler turns the quantizer's amax / 127 into a product with the
    reciprocal (the port's quantizer equals JAX's eager one bit for bit,
    tests/test_torch_quant.py)."""
    hkv, ps, d, num_pages, t = 2, 32, 64, 6, 70
    rng = np.random.default_rng(11)
    kn = rng.standard_normal((hkv, t, d)).astype(np.float32)
    vn = rng.standard_normal((hkv, t, d)).astype(np.float32)
    ids = [4, 1, 3]
    tdt, jdt = (torch.int8, jnp.int8) if kind == "int8" else (torch.bfloat16, jnp.bfloat16)
    tp = pgc.init_layer_pages(hkv, num_pages, ps, d, tdt, device="cpu")
    out = pgc.write_tokens(tp, np.asarray(ids), 5, torch.from_numpy(kn), torch.from_numpy(vn))
    assert out is tp
    jp = jpgc.write_tokens(jpgc.init_layer_pages(hkv, num_pages, ps, d, jdt),
                           jnp.asarray(ids, jnp.int32), 5, jnp.asarray(kn), jnp.asarray(vn))
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(tp, name), getattr(jp, name)
        if b is None:
            assert a is None
            continue
        b = np.asarray(b.astype(jnp.float32)) if kind == "bf16" and name in "kv" else np.asarray(b)
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        if name.endswith("scale"):
            np.testing.assert_allclose(a, b, rtol=2.0 ** -22, atol=0)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sq,skv,off", [(64, 160, 96), (32, 200, 168), (48, 48, 0), (100, 228, 128)])
def test_flash_q_offset_matches_jax(sq, skv, off):
    """Chunked prefill's attention: q rows at global positions off..off+Sq-1
    over off + Sq keys (or more, masked by causality)."""
    rng = np.random.default_rng(sq + off)
    (tq_, jq_), (tk, jk), (tv, jv) = (_bf16(rng.standard_normal((1, h, s, 64)))
                                      for h, s in ((4, sq), (2, skv), (2, skv)))
    got = tflash(tq_, tk, tv, is_causal=True, q_offset=off)
    want = jflash(jq_, jk, jv, is_causal=True, q_offset=jnp.int32(off), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    diff = got.float().numpy() - want
    assert np.isfinite(got.float().numpy()).all()
    assert np.abs(diff).max() <= K1_ATOL and np.sqrt(np.mean(diff ** 2)) < K1_RMSE
    # A 0-d tensor offset is the same call.
    assert torch.equal(tflash(tq_, tk, tv, is_causal=True, q_offset=torch.tensor(off)), got)


def test_flash_q_offset_equals_the_rows_of_a_longer_query():
    """Rows off.. of a causal attention over the whole sequence are the
    attention of those rows alone with q_offset = off."""
    rng = np.random.default_rng(5)
    (q, _), (k, _), (v, _) = (_bf16(rng.standard_normal((1, h, 96, 64))) for h in (4, 2, 2))
    full = tflash(q, k, v, is_causal=True)
    part = tflash(q[:, :, 40:], k, v, is_causal=True, q_offset=40)
    # fp32 products of other shapes may round differently: a bf16 ulp at most.
    assert float((part.float() - full[:, :, 40:].float()).abs().max()) <= 1.0 / 64
    # kv_offset (refused here before it was ported): K from row 3 on with
    # kv_offset = 3 under a window that hides rows 0-2 from rows 40.. gives
    # the same rows.
    windowed = tflash(q[:, :, 40:], k, v, is_causal=True, q_offset=40, window=(37, 0))
    cut = tflash(q[:, :, 40:], k[:, :, 3:], v[:, :, 3:], is_causal=True, q_offset=40,
                 kv_offset=3, window=(37, 0))
    assert float((cut.float() - windowed.float()).abs().max()) <= 1.0 / 64
