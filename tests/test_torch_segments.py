"""Segment ids (packed documents) in the port, on the CPU.

Every case holds the port against the JAX package on the same inputs, made
from numpy seeds; the JAX side runs its Pallas kernel in interpret mode, as
the JAX suite does (tests/test_flash.py:100-145, tests/test_engine.py:357-380).
Tolerances:

- ``sdpa_reference``: both in fp32 over the same fp32 inputs, 1e-5;
- K1's plain version against JAX's ``flash_attention``: both give bf16,
  JAX's kernel rounding P to bf16 where the plain version keeps fp32:
  max |diff| <= 2e-2; RMSE against the fp32 oracle < 1e-2, the repository's
  bar; rows whose segment matches no key are exact zeros on both sides (JAX
  flash.py:573-578);
- combinations the JAX suite does not run (GQA, windows, scales,
  residuals) are held to the fp32 oracle on the operands K1 multiplies
  (the quantized ones where the call quantizes) at the same RMSE bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu.ops.flash import flash_attention as jflash
from quantumattention_tpu.ops.sdpa import sdpa_reference as jsdpa
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash
from quantumattention_tpu_torch.ops.flash import _block_operands, keep_mask, residuals_plain
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
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int32: jnp.int32,
           torch.int64: jnp.int32}[t.dtype]
    return jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy()).astype(jdt)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _qkv(seed, b, hq, hkv, sq, skv, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    out = []
    for h, s in ((hq, sq), (hkv, skv), (hkv, skv)):
        t = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(dtype)
        out.append((t, _j(t)))
    return out


def _ids(lengths, batch=1):
    """(batch, sum(lengths)) int32 ids: segment i over lengths[i] rows."""
    row = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)]).astype(np.int32)
    return torch.from_numpy(np.repeat(row[None], batch, axis=0))


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


def _close_to_jax(want, got):
    a, b = _f32(want), _f32(got)
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=JAX_ATOL, rtol=0)
    empty = np.abs(a).sum(-1) == 0
    np.testing.assert_array_equal(b[empty], 0.0)


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_reference_segments_match_jax(causal):
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(1, 2, 4, 2, 40, 40, 32, torch.float32)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(np.sort(rng.integers(0, 4, (2, 40)), axis=1).astype(np.int32))
    got = tsdpa(tq_, tk, tv, is_causal=causal, q_segment_ids=ids, kv_segment_ids=ids)
    want = jsdpa(jq_, jk, jv, is_causal=causal, q_segment_ids=_j(ids), kv_segment_ids=_j(ids))
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("side", ["q", "kv"])
def test_sdpa_reference_needs_both_ids(side):
    q = torch.zeros((1, 2, 8, 16))
    ids = {f"{side}_segment_ids": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="both q/kv segment ids"):
        tsdpa(q, q, q, **ids)


# ---------------------------------------------------------------------------
# K1 (tests/test_flash.py:100-145)
# ---------------------------------------------------------------------------


def test_flash_segment_ids_packed_sequences_match_jax():
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(3, 2, 4, 4, 384, 384, 64)
    ids = _ids([100, 150, 134], batch=2)
    got = tflash(tq_, tk, tv, is_causal=True, q_segment_ids=ids, kv_segment_ids=ids)
    want = jflash(jq_, jk, jv, is_causal=True, q_segment_ids=_j(ids), kv_segment_ids=_j(ids),
                  block_q=128, block_kv=128, interpret=True)
    _close_to_jax(want, got)
    oracle = tsdpa(tq_, tk, tv, is_causal=True, q_segment_ids=ids, kv_segment_ids=ids,
                   out_dtype=torch.float32)
    assert rmse(got, oracle) < RMSE_BAR


def test_flash_segment_ids_ragged_match_jax():
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(4, 1, 2, 2, 250, 250, 64)
    ids = _ids([130, 120])
    got = tflash(tq_, tk, tv, q_segment_ids=ids, kv_segment_ids=ids)
    want = jflash(jq_, jk, jv, q_segment_ids=_j(ids), kv_segment_ids=_j(ids), block_q=128,
                  block_kv=128, interpret=True)
    _close_to_jax(want, got)
    oracle = tsdpa(tq_, tk, tv, q_segment_ids=ids, kv_segment_ids=ids, out_dtype=torch.float32)
    assert rmse(got, oracle) < RMSE_BAR


def test_fully_masked_segment_rows_output_zeros_match_jax():
    """tests/test_engine.py:357-380: a query whose segment matches no key
    gives exact zeros, the other rows the oracle's values."""
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(5, 1, 2, 2, 128, 128, 64, torch.float32)
    q_ids = torch.zeros((1, 128), dtype=torch.int32)
    q_ids[0, 5] = 99
    kv_ids = torch.zeros((1, 128), dtype=torch.int32)
    got = tflash(tq_, tk, tv, q_segment_ids=q_ids, kv_segment_ids=kv_ids)
    want = jflash(jq_, jk, jv, q_segment_ids=_j(q_ids), kv_segment_ids=_j(kv_ids), block_q=128,
                  block_kv=128, interpret=True)
    assert not bool(got[0, :, 5].any())
    np.testing.assert_array_equal(np.asarray(want[0, :, 5]), 0.0)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=JAX_ATOL, rtol=0)
    ref = tsdpa(tq_, tk, tv, q_segment_ids=q_ids, kv_segment_ids=kv_ids)
    assert float((got[0, :, :5] - ref[0, :, :5]).abs().max()) < 5e-2


def test_attn_func_segment_ids_match_jax():
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(6, 1, 2, 2, 200, 200, 64)
    ids = _ids([70, 60, 70])
    got = qt.attn_func(tq_, tk, tv, is_causal=True, q_segment_ids=ids, kv_segment_ids=ids)
    want = qj.attn_func(jq_, jk, jv, is_causal=True, q_segment_ids=_j(ids),
                        kv_segment_ids=_j(ids))
    _close_to_jax(want, got)


# ---------------------------------------------------------------------------
# Combinations, against the oracle
# ---------------------------------------------------------------------------

#: (causal, window, Hq, Hkv, Sq, Skv, scaling): GQA groups 1-4, ragged
#: Sq != Skv, windows with and without the causal mask, head-wise,
#: token-wise and per-block scaling.
COMBOS = [
    (True, None, 4, 1, 96, 96, "none"),
    (False, None, 4, 2, 70, 130, "none"),
    (True, (24, 0), 2, 2, 96, 96, "none"),
    (False, (16, 8), 4, 2, 96, 96, "none"),
    (True, None, 4, 2, 96, 96, "head"),
    (False, None, 2, 1, 80, 100, "token"),
    (True, None, 4, 2, 256, 256, "block"),
]


@pytest.mark.parametrize("causal,window,hq,hkv,sq,skv,scaling", COMBOS, ids=str)
def test_flash_segment_ids_combine(causal, window, hq, hkv, sq, skv, scaling):
    (tq_, _), (tk, _), (tv, _) = _qkv(7, 2, hq, hkv, sq, skv, 64)
    rng = np.random.default_rng(8)
    q_ids = torch.from_numpy(np.sort(rng.integers(0, 3, (2, sq)), axis=1).astype(np.int32))
    kv_ids = torch.from_numpy(np.sort(rng.integers(0, 3, (2, skv)), axis=1).astype(np.int32))
    kw = dict(is_causal=causal, window=window, q_segment_ids=q_ids, kv_segment_ids=kv_ids)
    # The oracle on the operands K1 multiplies: the quantized ones where the
    # call quantizes (the fp8 format's own error exceeds the bar on short
    # segments).
    operands = (tq_, tk, {})
    if scaling == "block":
        got = tflash(tq_, tk, tv, fused_block_quant=True, block_q=128, block_kv=128, **kw)
        q8, k8, sq_, sk_ = _block_operands(tq_, tk, 128, 128)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
    elif scaling != "none":
        fn = tq.quantize_head_wise if scaling == "head" else tq.quantize_token_wise
        (q8, sq_), (k8, sk_) = fn(tq_), fn(tk)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
        got = tflash(q8, k8, tv, **operands[2], **kw)
    else:
        got = tflash(tq_, tk, tv, **kw)
    oracle = tsdpa(operands[0], operands[1], tv, out_dtype=torch.float32, **operands[2], **kw)
    rows = keep_mask(sq, skv, causal, window, 0, 0, "cpu", q_ids, kv_ids).any(-1)
    rows = rows.expand(-1, hq, -1)
    assert got.shape == tq_.shape and bool(rows.any()) and bool(torch.isfinite(got).all())
    assert rmse(got[rows], oracle[rows]) < RMSE_BAR
    assert not bool(got[~rows].any())  # rows that see no key


def test_flash_segment_ids_residuals():
    """(m, l) with segment ids: those of the masked exp2-domain scores."""
    (tq_, _), (tk, _), (tv, _) = _qkv(9, 1, 2, 2, 96, 96, 64)
    ids = _ids([40, 56])
    out, (m, l) = tflash(tq_, tk, tv, is_causal=True, return_residuals=True, q_segment_ids=ids,
                         kv_segment_ids=ids)
    keep = torch.tril(torch.ones(96, 96, dtype=torch.bool)) & (ids[0][:, None] == ids[0][None])
    pm, pl = residuals_plain(tq_, tk, is_causal=True, keep=keep)
    torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, tflash(tq_, tk, tv, is_causal=True, q_segment_ids=ids,
                                   kv_segment_ids=ids))


def test_equal_segment_ids_change_nothing():
    (tq_, _), (tk, _), (tv, _) = _qkv(10, 1, 4, 2, 100, 100, 64)
    ids = torch.full((1, 100), 3, dtype=torch.int32)
    torch.testing.assert_close(
        tflash(tq_, tk, tv, is_causal=True, q_segment_ids=ids, kv_segment_ids=ids),
        tflash(tq_, tk, tv, is_causal=True), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Refusals (JAX flash.py:997-1006, dispatch.py:224-238)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["flash_attention", "attn_func"])
def test_segment_ids_validation_matches_jax(entry):
    (tq_, jq_), (tk, jk), (tv, jv) = _qkv(11, 1, 2, 2, 128, 128, 64)
    fn = tflash if entry == "flash_attention" else qt.attn_func
    with pytest.raises(ValueError, match="both"):
        fn(tq_, tk, tv, q_segment_ids=torch.zeros((1, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="both"):
        jflash(jq_, jk, jv, q_segment_ids=jnp.zeros((1, 128), jnp.int32), interpret=True)
    bad = torch.zeros((1, 127), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"segment ids must be \(B, Sq\) / \(B, Skv\)"):
        fn(tq_, tk, tv, q_segment_ids=bad, kv_segment_ids=bad)
    with pytest.raises(ValueError, match=r"segment ids must be \(B, Sq\) / \(B, Skv\)"):
        jflash(jq_, jk, jv, q_segment_ids=_j(bad), kv_segment_ids=_j(bad), interpret=True)


def test_segment_ids_are_forward_only():
    """Inputs that require grad raise: the path has no backward, and an
    output cut from the graph would hide that."""
    (tq_, _), (tk, _), (tv, _) = _qkv(12, 1, 2, 2, 64, 64, 64)
    ids = _ids([30, 34])
    with pytest.raises(ValueError, match="forward-only"):
        qt.attn_func(tq_.requires_grad_(), tk, tv, q_segment_ids=ids, kv_segment_ids=ids)
    with torch.no_grad():
        out = qt.attn_func(tq_, tk, tv, q_segment_ids=ids, kv_segment_ids=ids)
    assert out.shape == tq_.shape
