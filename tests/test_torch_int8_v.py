"""int8 V with per-channel scales (``scale_v``) in the port, on the CPU.

Every case holds the port against the JAX package on the same inputs, made
from numpy seeds; the JAX side runs its Pallas kernel in interpret mode, as
the JAX suite does (tests/test_fp8_flash.py:118-140).  Tolerances:

- ``quantize_channel_wise`` and ``dequantize(..., axis=-2)``: codes and
  scales equal to JAX's;
- K1's plain version against JAX's ``flash_attention``: max |diff| <= 5e-2.
  JAX rounds P to round(127 p) int8 for the TPU's 8-bit P.V
  (flash.py:501-515), 7 bits where the port keeps P in bf16 on the card
  and fp32 in the plain version;
- both against the fp32 oracle on the dequantized inputs: RMSE < 1e-2,
  the repository's bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.ops import quant as jquant
from quantumattention_tpu.ops.flash import flash_attention as jflash
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch.ops import flash as tf
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference as tsdpa

JAX_ATOL = 5e-2
RMSE_BAR = 1e-2
E4M3 = torch.float8_e4m3fn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(t: torch.Tensor):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int8: jnp.int8,
           E4M3: jnp.float8_e4m3fn}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
            for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


# ---------------------------------------------------------------------------
# The quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qdtype", ["int8", "e4m3"])
def test_quantize_channel_wise_matches_jax(qdtype):
    _, _, v = _qkv(1, 2, 2, 2, 33, 33, 48)
    v[0, 1, :, 5] = 0.0  # a zero channel: the scale's floor
    tdt, jdt = {"int8": (torch.int8, jnp.int8), "e4m3": (E4M3, jnp.float8_e4m3fn)}[qdtype]
    codes, scales = tq.quantize_channel_wise(v, tdt)
    jcodes, jscales = jquant.quantize_channel_wise(jnp.asarray(v.numpy()), jdt)
    assert codes.dtype == tdt and scales.shape == (2, 2, 48) and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.float().numpy(), np.asarray(jcodes.astype(jnp.float32)))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    deq = tq.dequantize(codes, scales, axis=-2)
    jdeq = jquant.dequantize(jcodes, jscales, axis=-2)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_dequantize_without_axis_is_unchanged():
    codes = torch.arange(24, dtype=torch.int8).reshape(1, 2, 3, 4)
    scales = torch.tensor([[0.5, 2.0]])
    assert torch.equal(tq.dequantize(codes, scales), codes.float() * scales[..., None, None])


# ---------------------------------------------------------------------------
# K1 against JAX (tests/test_fp8_flash.py:118-140)
# ---------------------------------------------------------------------------


def test_int8_qk_int8_pv_matches_jax():
    """JAX's full 8-bit path: int8 Q/K head-wise, int8 V channel-wise."""
    q, k, v = _qkv(7, 2, 4, 4, 512, 512, 128)
    (q8, sq), (k8, sk), (v8, sv) = (tq.quantize_head_wise(q, torch.int8),
                                    tq.quantize_head_wise(k, torch.int8),
                                    tq.quantize_channel_wise(v, torch.int8))
    got = tf.flash_attention(q8, k8, v8, scale_q=sq, scale_k=sk, scale_v=sv, is_causal=True)
    want = jflash(_j(q8), _j(k8), _j(v8), scale_q=_j(sq), scale_k=_j(sk), scale_v=_j(sv),
                  is_causal=True, block_q=128, block_kv=128, interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=JAX_ATOL, rtol=0)
    oracle = tsdpa(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True, out_dtype=torch.float32)
    assert rmse(got, oracle) < RMSE_BAR
    assert rmse(want, oracle) < RMSE_BAR


@pytest.mark.parametrize("qk", ["e4m3-head", "bf16"])
def test_int8_v_under_other_qk_matches_jax(qk):
    q, k, v = _qkv(8, 1, 4, 2, 256, 256, 64)
    v8, sv = tq.quantize_channel_wise(v, torch.int8)
    scales, jscales = {}, {}
    if qk == "bf16":
        q, k = q.bfloat16(), k.bfloat16()
    else:
        (q, sq), (k, sk) = tq.quantize_head_wise(q, E4M3), tq.quantize_head_wise(k, E4M3)
        scales, jscales = dict(scale_q=sq, scale_k=sk), dict(scale_q=_j(sq), scale_k=_j(sk))
    got = tf.flash_attention(q, k, v8, scale_v=sv, is_causal=True, **scales)
    want = jflash(_j(q), _j(k), _j(v8), scale_v=_j(sv), is_causal=True, block_q=128,
                  block_kv=128, interpret=True, **jscales)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=JAX_ATOL, rtol=0)
    oracle = tsdpa(q, k, tq.dequantize(v8, sv, axis=-2), is_causal=True,
                   out_dtype=torch.float32, **scales)
    assert rmse(got, oracle) < RMSE_BAR


# ---------------------------------------------------------------------------
# Combinations, against the oracle
# ---------------------------------------------------------------------------

#: (causal, window, Hq, Hkv, Sq, Skv, D, scaling, residuals)
COMBOS = [
    (True, None, 4, 1, 100, 100, 64, "none", False),
    (False, None, 4, 2, 70, 130, 128, "head", False),
    (True, (40, 0), 2, 2, 96, 96, 64, "token", False),
    (False, (30, 10), 4, 2, 96, 96, 64, "none", True),
    (True, None, 4, 2, 256, 256, 128, "block", False),
    (True, None, 2, 2, 64, 64, 72, "head", True),
]


@pytest.mark.parametrize("causal,window,hq,hkv,sq,skv,d,scaling,residuals", COMBOS, ids=str)
def test_int8_v_combines(causal, window, hq, hkv, sq, skv, d, scaling, residuals):
    q, k, v = _qkv(9, 2, hq, hkv, sq, skv, d)
    q, k = q.bfloat16(), k.bfloat16()
    v8, sv = tq.quantize_channel_wise(v, torch.int8)
    kw = dict(is_causal=causal, window=window, scale_v=sv, return_residuals=residuals)
    operands = (q, k, {})
    if scaling == "block":
        res = tf.flash_attention(q, k, v8, fused_block_quant=True, block_q=128, block_kv=128, **kw)
        q8, k8, sq_, sk_ = tf._block_operands(q, k, 128, 128)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
    elif scaling != "none":
        fn = tq.quantize_head_wise if scaling == "head" else tq.quantize_token_wise
        (q8, sq_), (k8, sk_) = fn(q, torch.int8), fn(k, torch.int8)
        operands = (q8, k8, {"scale_q": sq_, "scale_k": sk_})
        res = tf.flash_attention(q8, k8, v8, **operands[2], **kw)
    else:
        res = tf.flash_attention(q, k, v8, **kw)
    out = res[0] if residuals else res
    keep = tf.keep_mask(sq, skv, causal, window, 0, 0, "cpu")
    oracle = tsdpa(operands[0], operands[1], tq.dequantize(v8, sv, axis=-2), attn_mask=keep,
                   out_dtype=torch.float32, **operands[2])
    rows = keep.any(-1) if keep is not None else torch.ones(sq, dtype=torch.bool)
    assert out.dtype == torch.bfloat16 and out.shape == (2, hq, sq, d)
    assert rmse(out[:, :, rows], oracle[:, :, rows]) < RMSE_BAR
    assert not bool(out[:, :, ~rows].any())
    if residuals:
        m, l = tf.residuals_plain(operands[0], operands[1], is_causal=causal, window=window,
                                  **operands[2])
        torch.testing.assert_close(res[1][0], m, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(res[1][1], l, atol=1e-5, rtol=1e-5)


def test_int8_v_with_masks():
    """int8 V beside segment ids and a block mask."""
    q, k, v = _qkv(10, 1, 2, 2, 256, 256, 64)
    q, k = q.bfloat16(), k.bfloat16()
    v8, sv = tq.quantize_channel_wise(v, torch.int8)
    ids = torch.tensor([[0] * 100 + [1] * 156], dtype=torch.int32)
    bm = torch.tensor([[True, False], [True, True]])
    out = tf.flash_attention(q, k, v8, scale_v=sv, is_causal=True, q_segment_ids=ids,
                             kv_segment_ids=ids, block_mask=bm)
    keep = tf.keep_mask(256, 256, True, None, 0, 0, "cpu", ids, ids, bm)
    oracle = tsdpa(q, k, tq.dequantize(v8, sv, axis=-2), attn_mask=keep, out_dtype=torch.float32)
    assert rmse(out, oracle) < RMSE_BAR


def test_scale_v_beside_float_v_is_unused():
    """JAX checks a scale_v beside a float V and ignores it (flash.py:795-803)."""
    q, k, v = (t.bfloat16() for t in _qkv(11, 1, 2, 2, 64, 64, 64))
    sv = torch.full((1, 2, 64), 3.0)
    assert torch.equal(tf.flash_attention(q, k, v, scale_v=sv), tf.flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# Refusals (JAX flash.py:795-803)
# ---------------------------------------------------------------------------


def test_int8_v_validation_matches_jax():
    q, k, v = _qkv(12, 1, 2, 2, 128, 128, 64)
    q, k = q.bfloat16(), k.bfloat16()
    v8, sv = tq.quantize_channel_wise(v, torch.int8)
    with pytest.raises(ValueError, match=r"int8 v requires per-channel scale_v \(B, Hkv, D\)"):
        tf.flash_attention(q, k, v8)
    with pytest.raises(ValueError, match=r"int8 v requires per-channel scale_v \(B, Hkv, D\)"):
        jflash(_j(q), _j(k), _j(v8), interpret=True)
    with pytest.raises(ValueError, match=r"scale_v must be \(B, Hkv, D\)"):
        tf.flash_attention(q, k, v8, scale_v=sv[:, :, :32])
    with pytest.raises(ValueError, match=r"scale_v must be \(B, Hkv, D\)"):
        jflash(_j(q), _j(k), _j(v8), scale_v=_j(sv[:, :, :32]), interpret=True)


def test_entry_points_refuse_int8_v():
    """``attn_func`` takes no scale_v, and refuses an int8 V with JAX's
    reason, as JAX's dispatch does."""
    q, k, v = _qkv(13, 1, 2, 2, 64, 64, 64)
    v8, _ = tq.quantize_channel_wise(v, torch.int8)
    ok, why = qt.can_use_attention(q.bfloat16(), k.bfloat16(), v8)
    assert not ok and "value dtype" in why
