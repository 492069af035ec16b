"""The multi-query (speculative verification) mode of K4 and K10, on the CPU.

- K4's plain version with a (B, Hq, T, D) query against JAX's
  ``decode_attention`` with the same 4-D query, its Pallas kernel in
  interpret mode, over int8, packed int4, bf16, float16 and float32
  caches.  Tolerance: ATOL 1/64, as tests/test_torch_decode.py (both
  return bf16; the plain version rounds P to bf16 where JAX's kernel
  rounds it to the cache's type for float16 and float32 caches, a
  difference far below 1/64 on these averages).
- K10's plain version against JAX's ``paged_decode_attention`` with
  ``use_dma=True`` (the DMA path whose math K10 ports): ATOL 1/32, as
  tests/test_torch_paged.py.
- Inside the port, exactly: row t of a 4-D call equals a 3-D call at
  ``lengths - (T - 1 - t)``, and a 4-D call with T = 1 equals the 3-D call.

Lengths include 0 (an empty slot: zeros) and T (a slot holding only the
candidates).  A slot shorter than T has rows whose every column is masked;
neither kernel defines them, so no case has one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.ops.decode import decode_attention as jdecode
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
from quantumattention_tpu.serving.backends import SlotsBackend as JSlots
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.decode import decode_attention as tdecode
from quantumattention_tpu_torch.ops.paged import paged_decode_attention as tpaged
from quantumattention_tpu_torch.serving.backends import PagedBackend, SlotsBackend

K4_ATOL = 1.0 / 64
K10_ATOL = 1.0 / 32
B, HKV, D, SMAX = 3, 2, 64, 128
KINDS = ["int8", "int4", "bf16", "f16", "f32"]
FLOAT_TYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


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


def _j(t: torch.Tensor):
    """The same values as a jax array of the matching type."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8, torch.int32: jnp.int32,
           torch.float32: jnp.float32, torch.float16: jnp.float16}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _rows(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _quantized(kind, k, v):
    """(k, v, k_scale, v_scale) of float rows in the cache type ``kind``."""
    if kind in FLOAT_TYPES:
        return k.to(FLOAT_TYPES[kind]), v.to(FLOAT_TYPES[kind]), None, None
    if kind == "int8":
        fn = tq.dynamically_quantize_int8
    else:
        fn = tq.dynamically_quantize_int4
    (kc, ks), (vc, vs) = fn(k, reduction_dim=-1), fn(v, reduction_dim=-1)
    return kc, vc, ks, vs


def _slot_inputs(kind, group, t, seed=0):
    rng = np.random.default_rng(seed + 10 * group + t)
    q = _rows(rng, (B, HKV * group, t, D)).to(torch.bfloat16)
    cache = _quantized(kind, _rows(rng, (B, HKV, SMAX, D)), _rows(rng, (B, HKV, SMAX, D)))
    lens = torch.tensor([0, t, 100], dtype=torch.int32)
    return q, cache, lens


def _close(got, want, atol, empty=(0,)):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert got.shape == want.shape
    for i in empty:
        assert torch.equal(got[i], torch.zeros_like(got[i]))
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_verify_matches_jax(kind, group, t):
    q, (kc, vc, ks, vs), lens = _slot_inputs(kind, group, t)
    got = tdecode(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    want = jdecode(_j(q), _j(kc), _j(vc), _j(lens), k_scale=None if ks is None else _j(ks),
                   v_scale=None if vs is None else _j(vs), interpret=True)
    _close(got, want, K4_ATOL)


def _paged_inputs(kind, group, t, ps=32, pps=4, seed=1):
    """A shuffled pool of pages of ``kind`` (int4 token-packed), its table
    and a (B, Hq, T, D) query."""
    rng = np.random.default_rng(seed + 10 * group + t)
    pool = B * pps + 3
    kf, vf = _rows(rng, (HKV, pool, ps, D)), _rows(rng, (HKV, pool, ps, D))
    if kind == "int4":
        (k, ks), (v, vs) = (tq.quantize_int4_values(x, reduction_dim=-1) for x in (kf, vf))
        k, v = tq.pack_int4(k, axis=2), tq.pack_int4(v, axis=2)
    else:
        k, v, ks, vs = _quantized(kind, kf, vf)
    table = torch.from_numpy(rng.permutation(pool)[: B * pps].reshape(B, pps).astype(np.int32))
    q = _rows(rng, (B, HKV * group, t, D)).to(torch.bfloat16)
    lens = torch.tensor([t, 0, pps * ps - 5], dtype=torch.int32)
    return q, k, v, ks, vs, lens, table


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_paged_verify_matches_jax_dma_kernel(kind, group, t):
    q, k, v, ks, vs, lens, table = _paged_inputs(kind, group, t)
    got = tpaged(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs, pages_per_block=2)
    want = jpaged(_j(q), _j(k), _j(v), _j(lens), _j(table),
                  k_scale_pages=None if ks is None else _j(ks),
                  v_scale_pages=None if vs is None else _j(vs), pages_per_block=2,
                  use_dma=True, interpret=True)
    _close(got, want, K10_ATOL, empty=(1,))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_verify_rows_are_shifted_single_queries(kernel, kind):
    """Candidate t of a T = 4 call is the one-query call at lengths - (T - 1
    - t), bit for bit; a (B, Hq, 1, D) call is the (B, Hq, D) call."""
    t_max, group = 4, 2
    if kernel == "k4":
        q, (kc, vc, ks, vs), _ = _slot_inputs(kind, group, t_max, seed=5)
        lens = torch.tensor([t_max, 9, 100], dtype=torch.int32)

        def call(query, lengths):
            return tdecode(query, kc, vc, lengths, k_scale=ks, v_scale=vs)
    else:
        q, k, v, ks, vs, _, table = _paged_inputs(kind, group, t_max, seed=5)
        lens = torch.tensor([t_max, 9, 123], dtype=torch.int32)

        def call(query, lengths):
            return tpaged(query, k, v, lengths, table, k_scale_pages=ks, v_scale_pages=vs,
                          pages_per_block=2)
    out = call(q, lens)
    assert out.shape == q.shape
    for t in range(t_max):
        one = call(q[:, :, t].contiguous(), lens - (t_max - 1 - t))
        assert torch.equal(out[:, :, t], one), t
    single = call(q[:, :, 0].contiguous(), lens)
    assert torch.equal(call(q[:, :, :1].contiguous(), lens)[:, :, 0], single)


# ---------------------------------------------------------------------------
# The model and the backends in verify mode
# ---------------------------------------------------------------------------

LOGIT_REL = 0.03  # tests/test_torch_llama.py: bf16 layers rounded in other places


@pytest.fixture(scope="module")
def model():
    """The JAX tiny Llama's weights, and the same weights in the port."""
    jp = jl.init_params(jax.random.PRNGKey(0), jl.tiny())
    return jp, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tl.tiny(), device="cpu")


def _rel_close(t, j):
    a = np.asarray(j.astype(jnp.float32)) if not isinstance(j, torch.Tensor) else j.float().numpy()
    b = t.float().numpy()
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=LOGIT_REL * np.abs(a).max(), rtol=0)


def test_forward_chunk_takes_per_row_positions(model):
    """(B, T) positions (each row's chunk at its own offset, as verification
    gives) through ``forward_chunk`` in both packages, with the same causal
    attention within the chunk."""
    jp, tp = model
    toks = np.random.default_rng(1).integers(0, 256, (2, 5)).astype(np.int32)
    pos = np.array([[3, 4, 5, 6, 7], [17, 18, 19, 20, 21]], np.int32)

    def jattend(_i, q, k, v):
        g = q.shape[1] // k.shape[1]
        k, v = jnp.repeat(k, g, axis=1).astype(jnp.float32), jnp.repeat(v, g, axis=1).astype(jnp.float32)
        s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), k) / np.sqrt(q.shape[-1])
        s = jnp.where(jnp.tril(jnp.ones((5, 5), bool)), s, -1e30)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)

    def tattend(_i, q, k, v):
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, dim=1).float(), v.repeat_interleave(g, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / np.sqrt(q.shape[-1])
        s = s.masked_fill(~torch.tril(torch.ones(5, 5, dtype=torch.bool)), -1e30)
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)

    got = tl.forward_chunk(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos), tl.tiny(), tattend)
    want = jl.forward_chunk(jp, jnp.asarray(toks), jnp.asarray(pos), jl.tiny(), jattend)
    _rel_close(got, want)
    # Row 1 at its own offset is not row 1 at row 0's positions.
    shifted = tl.forward_chunk(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos[[0, 0]]),
                               tl.tiny(), tattend)
    assert not torch.allclose(shifted[1], got[1])


@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_slots_verify_matches_jax_backend(model, cache):
    """The slots backend's ``verify`` (T candidates appended at each active
    slot's own length, K4's multi-query plain version) against JAX's
    ``SlotsBackend.verify`` after the same prefill; an inactive slot is
    neither written nor grown; ``rollback`` sets the kept lengths in both."""
    jp, tp = model
    tdt, jdt = (torch.int8, jnp.int8) if cache == "int8" else (torch.bfloat16, jnp.bfloat16)
    toks = np.random.default_rng(2).integers(0, 256, (3, 40)).astype(np.int32)
    lens = [40, 21, 9]
    jb = JSlots(jl.tiny(), num_slots=3, max_len=64, cache_dtype=jdt)
    tb = SlotsBackend(tl.tiny(), num_slots=3, max_len=64, cache_dtype=tdt, device="cpu")
    jb.prefill_and_write(functools.partial(jl.forward_prefill, cfg=jl.tiny()), jp, jnp.asarray(toks),
                         [n - 1 for n in lens], [0, 1, 2], lens, 40)
    tb.prefill_and_write(functools.partial(tl.forward_prefill, cfg=tl.tiny()), tp,
                         torch.from_numpy(toks).long(), [n - 1 for n in lens], [0, 1, 2], lens, 40)
    cand = np.random.default_rng(3).integers(0, 256, (3, 4)).astype(np.int32)
    active = np.array([True, True, False])
    positions = tb.host_lengths()
    want = jb.verify(jp, jnp.asarray(cand), jb.host_lengths(), active)
    got = tb.verify(tp, torch.from_numpy(cand), positions, active)
    assert got.shape == (3, 4, 256)
    _rel_close(got[:2], want[:2])
    np.testing.assert_array_equal(tb.host_lengths(), [44, 25, 9])
    np.testing.assert_array_equal(tb.host_lengths(), jb.host_lengths())
    keep = np.array([42, 22, 0], np.int32)
    for b in (jb, tb):
        b.rollback(np.array([True, True, False]), keep)
    np.testing.assert_array_equal(tb.host_lengths(), [42, 22, 9])
    np.testing.assert_array_equal(tb.host_lengths(), jb.host_lengths())


@pytest.mark.parametrize("int4", [False, True])
def test_paged_verify_equals_slots_verify(model, int4):
    """The paged backend's ``verify`` (the T candidates written through each
    slot's page table, grown where the reservation ends; K10's multi-query
    plain version) gives the slots backend's logits over the same prefill;
    the host lengths stay until ``rollback``."""
    _, tp = model
    cfg = tl.tiny()
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64)).astype(np.int64))
    lens = [64, 30]
    prefill = functools.partial(tl.forward_prefill, cfg=cfg)
    dt = torch.int8 if int4 else torch.bfloat16
    sb = SlotsBackend(cfg, num_slots=2, max_len=128, cache_dtype=dt, kv_int4=int4, device="cpu")
    pb = PagedBackend(cfg, num_slots=2, max_len=128, cache_dtype=dt, kv_int4=int4, page_size=16,
                      device="cpu")
    for slot, n in enumerate(lens):
        pb.alloc.allocate(slot, n, 16)  # exactly the prompt: verify grows it
    for b in (sb, pb):
        b.prefill_and_write(prefill, tp, toks, [n - 1 for n in lens], [0, 1], lens, 64)
    cand = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 5)))
    active = np.array([True, True])
    want = sb.verify(tp, cand, np.array(lens), active)
    got = pb.verify(tp, cand, np.array(lens), active)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_REL * float(want.abs().max()))
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() > 0.8
    np.testing.assert_array_equal(pb.host_lengths(), lens)
    assert list(pb.alloc.allocated[:2]) == [5, 3]  # ceil(69 / 16), ceil(35 / 16)
    pb.rollback(active, np.array([66, 31]))
    np.testing.assert_array_equal(pb.host_lengths(), [66, 31])
