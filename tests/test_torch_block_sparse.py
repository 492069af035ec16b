"""Block-sparse masks (``block_mask``) in the port, on the CPU.

Every case holds the port against the JAX package on the same inputs, made
from numpy seeds; the JAX side runs its Pallas kernel in interpret mode, as
the JAX suite does (tests/test_flash.py:148-235).  Tolerances:

- K1's plain version against JAX's ``attn_func``: both give bf16, JAX's
  kernel rounding P to bf16 where the plain version keeps fp32:
  max |diff| <= 2e-2; RMSE against the fp32 oracle < 1e-2, the
  repository's bar; granule rows with no active granule are exact zeros;
- K1's tile list (``block_table``) against a numpy copy of JAX's
  compaction (flash.py:913-940) at each of K1's tile configurations:
  equal counts and equal tiles;
- an all-ones mask gives the bits of the call without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu.ops.flash import MASK_GRANULE as J_GRANULE
from quantumattention_tpu.ops.sdpa import sdpa_reference as jsdpa
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import autotune
from quantumattention_tpu_torch.ops import flash as tf
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference as tsdpa

JAX_ATOL = 2e-2
RMSE_BAR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(t: torch.Tensor):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    out = []
    for h, s in ((hq, sq), (hkv, skv), (hkv, skv)):
        t = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).bfloat16()
        out.append((t, _j(t)))
    return out


def _expand(bm, sq, skv, g=128):
    """tests/test_flash.py:143-146."""
    e = np.repeat(np.repeat(np.asarray(bm, bool), g, axis=0), g, axis=1)
    return e[:sq, :skv]


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


def _check(want, got, elem, q, k, v):
    a, b = _f32(want), _f32(got)
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=JAX_ATOL, rtol=0)
    oracle = tsdpa(q, k, v, attn_mask=torch.from_numpy(elem), out_dtype=torch.float32)
    rows = elem.any(-1)
    assert rmse(got[:, :, rows], oracle[:, :, rows]) < RMSE_BAR
    np.testing.assert_array_equal(b[:, :, ~rows], 0.0)


def test_mask_granule_is_jax():
    assert tf.MASK_GRANULE == J_GRANULE == 128


# ---------------------------------------------------------------------------
# K1 against JAX (tests/test_flash.py:148-235)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_causal", [False, True])
def test_block_sparse_mask_matches_jax(is_causal):
    s = 1024
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(41, 1, 2, 2, s, s, 64)
    rng = np.random.RandomState(0)
    bm = rng.rand(s // 128, s // 128) < 0.5
    bm[np.arange(s // 128), np.arange(s // 128)] = True
    got = qt.attn_func(tq_, tk, tv, is_causal=is_causal, block_mask=torch.from_numpy(bm))
    want = qj.attn_func(jq_, jk, jv, is_causal=is_causal, block_mask=jnp.asarray(bm))
    elem = _expand(bm, s, s)
    if is_causal:
        elem = elem & np.tril(np.ones((s, s), bool))
    _check(want, got, elem, tq_, tk, tv)


def test_block_sparse_ragged_and_gqa_match_jax():
    b, hq, hkv, sq, skv, d = 1, 4, 2, 250, 999, 64
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(43, b, hq, hkv, sq, skv, d)
    rng = np.random.RandomState(1)
    bm = rng.rand(-(-sq // 128), -(-skv // 128)) < 0.6
    bm[0, 0] = True
    got = qt.attn_func(tq_, tk, tv, block_mask=torch.from_numpy(bm).to(torch.int32))
    want = qj.attn_func(jq_, jk, jv, block_mask=jnp.asarray(bm))
    _check(want, got, _expand(bm, sq, skv), tq_, tk, tv)


def test_block_sparse_fully_masked_rows_zero_match_jax():
    s = 512
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(44, 1, 2, 2, s, s, 64)
    bm = np.ones((4, 4), bool)
    bm[2, :] = False  # rows 256:384 attend to nothing
    got = qt.attn_func(tq_, tk, tv, block_mask=torch.from_numpy(bm))
    want = qj.attn_func(jq_, jk, jv, block_mask=jnp.asarray(bm))
    assert not bool(got[:, :, 256:384].any())
    assert bool(got[:, :, :256].any())
    _check(want, got, _expand(bm, s, s), tq_, tk, tv)


# ---------------------------------------------------------------------------
# Combinations, against the oracle
# ---------------------------------------------------------------------------

#: (causal, window, Hq, Hkv, Sq, Skv, scaling): GQA, ragged shapes, windows
#: with and without the causal mask, head-wise, token-wise and per-block.
COMBOS = [
    (True, None, 4, 1, 300, 300, "none"),
    (False, (100, 50), 4, 2, 300, 260, "none"),
    (True, (150, 0), 2, 2, 384, 384, "none"),
    (True, None, 4, 2, 256, 256, "head"),
    (False, None, 2, 1, 200, 300, "token"),
    (True, None, 4, 2, 256, 256, "block"),
]


@pytest.mark.parametrize("causal,window,hq,hkv,sq,skv,scaling", COMBOS, ids=str)
def test_block_sparse_combine(causal, window, hq, hkv, sq, skv, scaling):
    (tq_, _), (tk, _), (tv, _) = _qkv(45, 2, hq, hkv, sq, skv, 64)
    rng = np.random.RandomState(2)
    bm = torch.from_numpy(rng.rand(-(-sq // 128), -(-skv // 128)) < 0.6)
    kw = dict(is_causal=causal, window=window, block_mask=bm)
    operands = (tq_, tk, {})
    if scaling == "block":
        got = tf.flash_attention(tq_, tk, tv, fused_block_quant=True, block_q=128, block_kv=128,
                                 **kw)
        q8, k8, sq_, sk_ = tf._block_operands(tq_, tk, 128, 128)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
    elif scaling != "none":
        fn = tq.quantize_head_wise if scaling == "head" else tq.quantize_token_wise
        (q8, sq_), (k8, sk_) = fn(tq_), fn(tk)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
        got = tf.flash_attention(q8, k8, tv, **operands[2], **kw)
    else:
        got = tf.flash_attention(tq_, tk, tv, **kw)
    keep = tf.keep_mask(sq, skv, causal, window, 0, 0, "cpu", block_mask=bm)
    oracle = tsdpa(operands[0], operands[1], tv, attn_mask=keep, out_dtype=torch.float32,
                   **operands[2])
    rows = keep.any(-1)
    assert got.shape == tq_.shape and bool(torch.isfinite(got).all())
    assert rmse(got[:, :, rows], oracle[:, :, rows]) < RMSE_BAR
    assert not bool(got[:, :, ~rows].any())


def test_block_sparse_residuals():
    (tq_, _), (tk, _), (tv, _) = _qkv(46, 1, 2, 2, 256, 256, 64)
    bm = torch.tensor([[True, False], [True, True]])
    out, (m, l) = tf.flash_attention(tq_, tk, tv, return_residuals=True, block_mask=bm)
    keep = tf.keep_mask(256, 256, False, None, 0, 0, "cpu", block_mask=bm)
    pm, pl = tf.residuals_plain(tq_, tk, keep=keep)
    torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, tf.flash_attention(tq_, tk, tv, block_mask=bm))


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int8, torch.int64])
def test_all_ones_mask_changes_nothing(dtype):
    (tq_, _), (tk, _), (tv, _) = _qkv(47, 1, 4, 2, 200, 300, 64)
    bm = torch.ones((2, 3), dtype=dtype)
    assert torch.equal(tf.flash_attention(tq_, tk, tv, is_causal=True, block_mask=bm),
                       tf.flash_attention(tq_, tk, tv, is_causal=True))


def test_mask_entries_above_zero_are_active():
    """JAX casts the mask to int32 and keeps entries > 0 (flash.py:887-895)."""
    got = tf.granules(torch.tensor([[2, 0], [-1, 1]]), 256, 256, "cpu")
    assert got.tolist() == [[True, False], [False, True]]


# ---------------------------------------------------------------------------
# K1's tile list against JAX's compaction
# ---------------------------------------------------------------------------


def _jax_compaction(bm, sq, skv, bq, bkv, causal, window):
    """JAX's compacted grid (flash.py:913-940) at Q blocks of ``bq`` rows and
    KV tiles of ``bkv`` keys, with its in-kernel window skip
    (flash.py:258-283) folded in: per Q block the count and the ascending
    active tiles."""
    elem = _expand(bm, sq, skv)
    n_q, n_kv = -(-sq // bq), -(-skv // bkv)
    act = np.zeros((n_q, n_kv), bool)
    for i in range(n_q):
        for j in range(n_kv):
            act[i, j] = elem[i * bq:(i + 1) * bq, j * bkv:(j + 1) * bkv].any()
    ii, jj = np.arange(n_q)[:, None], np.arange(n_kv)[None, :]
    if causal:
        act &= (jj * bkv) <= (ii * bq + bq - 1)
    if window is not None:
        left, right = window
        if left is not None:
            act &= (jj * bkv + bkv - 1) >= (ii * bq - left)
        if right is not None and not causal:
            act &= (jj * bkv) <= (ii * bq + bq - 1 + right)
    act &= (jj * bkv) < skv
    return act.sum(axis=1), [np.flatnonzero(act[r]) for r in range(n_q)]


TABLE_SHAPES = [(1024, 1024, 0.4), (250, 999, 0.6), (700, 333, 0.5), (1, 129, 1.0)]
TABLE_MASKS = [(False, None), (True, None), (True, (300, 0)), (False, (200, 100)), (False, (None, 64))]


@pytest.mark.parametrize("causal,window", TABLE_MASKS, ids=str)
@pytest.mark.parametrize("sq,skv,density", TABLE_SHAPES, ids=str)
@pytest.mark.parametrize("tiles", sorted({c[0] for c in autotune.K1_TILES.values()}), ids=str)
def test_block_table_is_jax_compaction(tiles, sq, skv, density, causal, window):
    bq, bkv = tiles
    rng = np.random.RandomState(sq + skv)
    bm = rng.rand(-(-sq // 128), -(-skv // 128)) < density
    counts, table = tf.block_table(torch.from_numpy(bm), sq, skv, bq, bkv, causal, window)
    want_counts, want_rows = _jax_compaction(bm, sq, skv, bq, bkv, causal, window)
    assert counts.dtype == table.dtype == torch.int32
    assert table.shape == (-(-sq // bq), -(-skv // bkv))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    for r, want in enumerate(want_rows):
        np.testing.assert_array_equal(table[r, :len(want)].numpy(), want)
        assert sorted(table[r].tolist()) == list(range(table.shape[1]))


def test_block_table_takes_no_host_values():
    """The table is built by torch ops alone: a mask whose values a
    function cannot read (a meta tensor) still gives tensors of the right
    shapes, so nothing in it waits for the device."""
    bm = torch.empty((8, 8), dtype=torch.bool, device="meta")
    counts, table = tf.block_table(bm, 1024, 1024, 192, 64, True, (300, 0))
    assert counts.shape == (6,) and table.shape == (6, 16) and counts.device.type == "meta"


# ---------------------------------------------------------------------------
# Refusals (JAX flash.py:880-895)
# ---------------------------------------------------------------------------


def test_block_mask_shape_validation_matches_jax():
    q = torch.zeros((1, 2, 512, 64), dtype=torch.bfloat16)
    jq = jnp.zeros((1, 2, 512, 64), jnp.bfloat16)
    with pytest.raises(ValueError, match=r"block_mask must be \(ceil\(Sq/128\), ceil\(Skv/128\)\)"):
        qt.attn_func(q, q, q, block_mask=torch.ones((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"block_mask must be \(ceil\(Sq/128\), ceil\(Skv/128\)\)"):
        qj.attn_func(jq, jq, jq, block_mask=jnp.ones((3, 4), jnp.int32))


@pytest.mark.parametrize("offset", ["q_offset", "kv_offset"])
def test_block_mask_with_offsets_raises(offset):
    q = torch.zeros((1, 2, 256, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_mask with ring position offsets"):
        tf.flash_attention(q, q, q, block_mask=torch.ones((2, 2), dtype=torch.bool),
                           **{offset: 0})


def test_block_mask_is_forward_only():
    (tq_, _), (tk, _), (tv, _) = _qkv(48, 1, 2, 2, 128, 128, 64)
    bm = torch.ones((1, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="forward-only"):
        qt.attn_func(tq_, tk.requires_grad_(), tv, block_mask=bm)


def test_oracle_with_expanded_mask_matches_jax():
    """The mask the plain version builds, through both oracles."""
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(49, 1, 2, 2, 200, 300, 32)
    bm = np.array([[True, False, True], [False, True, True]])
    keep = tf.keep_mask(200, 300, False, None, 0, 0, "cpu", block_mask=torch.from_numpy(bm))
    np.testing.assert_array_equal(keep.numpy(), _expand(bm, 200, 300))
    got = tsdpa(tq_.float(), tk.float(), tv.float(), attn_mask=keep)
    want = jsdpa(jq_.astype(jnp.float32), jk.astype(jnp.float32), jv.astype(jnp.float32),
                 attn_mask=jnp.asarray(_expand(bm, 200, 300))[None, None])
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)
