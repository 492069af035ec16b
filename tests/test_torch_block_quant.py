"""Per-block quantization (``scaling_method="per-block"``) against the JAX package.

The port's quantizer ``quant.quantize_block_wise`` is held to the JAX
kernel's tile math (flash.py:227-238) run in jnp: codes and scales equal.
The forward (K1's plain version on the CPU, and the entry points) is held
to JAX's ``flash_attention(fused_block_quant=True, interpret=True)`` and
``fp8_attn_func(scaling_method="per-block")`` with JAX's e4m3 container
(``attention.fp8_dot``; its int8 container is a TPU MXU gate the port does
not have), at test_torch_flash.py's tolerance: atol 1/16 and RMSE 2e-3, the
bf16 rounding of P and of the output in JAX's kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu import config as jconfig
from quantumattention_tpu.ops import flash as jflash_mod
from quantumattention_tpu.ops.flash import flash_attention as jflash
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import config as tconfig
from quantumattention_tpu_torch.models import llama
from quantumattention_tpu_torch.ops import flash as tflash_mod
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.serving import backends

ATOL = 1.0 / 16
RMSE_MAX = 2e-3


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arrs, dtype=torch.bfloat16):
    tt = [torch.from_numpy(a).to(dtype) for a in arrs]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jj = [jnp.asarray(t.float().numpy()).astype(jdt) for t in tt]
    return tt, jj


def _qkv(seed, s, hq=4, hkv=2, d=64, skv=None):
    skv = s if skv is None else skv
    return _pair(_arrays(seed, [(1, hq, s, d), (1, hkv, skv, d), (1, hkv, skv, d)]))


def _close(j_out, t_out):
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    assert np.sqrt(np.mean((a - b) ** 2)) < RMSE_MAX


def _jax_tile_quant(x, block_rows):
    """The JAX kernel's ``_quantize_tile`` over each block of rows (rows
    past S padded with zeros, as its sequence padding does)."""
    xf = x.astype(jnp.float32)
    b, h, s, d = xf.shape
    nb = -(-s // block_rows)
    xp = jnp.pad(xf, [(0, 0), (0, 0), (0, nb * block_rows - s), (0, 0)])
    blocks = xp.reshape(b, h, nb, block_rows, d)
    scale = jnp.maximum(jnp.max(jnp.abs(blocks), axis=(-2, -1)) / 448.0, 1e-12)
    codes = (blocks * (1.0 / scale)[..., None, None]).astype(jnp.float8_e4m3fn)
    return codes.reshape(b, h, nb * block_rows, d)[:, :, :s], scale


@pytest.mark.parametrize("shape,block_rows,dtype", [
    ((1, 2, 256, 64), 128, torch.bfloat16),
    ((2, 3, 200, 72), 64, torch.bfloat16),
    ((1, 2, 130, 128), 1024, torch.float32),
    ((1, 1, 77, 64), 50, torch.float32),
])
def test_quantize_block_wise_matches_jax_tile_math(shape, block_rows, dtype):
    x = _arrays(1, [shape])[0] * 3.0
    x[0, 0, 5] *= 40.0  # an outlier row in the first block only
    (tx,), (jx,) = _pair([x], dtype)
    t_codes, t_scale = tq.quantize_block_wise(tx, block_rows)
    j_codes, j_scale = _jax_tile_quant(jx, block_rows)
    np.testing.assert_array_equal(t_scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(t_codes.view(torch.uint8).numpy(),
                                  np.asarray(j_codes).view(np.uint8))


def test_block_quant_wrapper_pads_and_expands():
    """The kernel wrapper's plain version: codes at K1's row width (zero
    columns where D % 16 == 8) and each row's scale."""
    (tx,), _ = _pair(_arrays(2, [(1, 2, 150, 72)]))
    codes, scales, rows = tq.block_quant(tx, 64)
    want_codes, want_scales = tq.quantize_block_wise(tx, 64)
    assert codes.shape == (1, 2, 150, 80) and codes.dtype == torch.float8_e4m3fn
    assert torch.equal(codes[..., :72].view(torch.uint8), want_codes.view(torch.uint8))
    assert not codes[..., 72:].view(torch.uint8).any()
    assert torch.equal(scales, want_scales) and scales.shape == (1, 2, 3)
    assert torch.equal(rows, torch.repeat_interleave(want_scales, 64, dim=-1)[..., :150])


CASES = ("mha", "gqa_window", "ragged", "offsets", "noncausal", "default_blocks")


@pytest.mark.parametrize("case", CASES)
def test_flash_per_block_matches_jax(case):
    kw = dict(is_causal=True, block_q=128, block_kv=128)
    hq, hkv, s, skv = 4, 2, 256, None
    j_extra, t_extra = {}, {}
    if case == "mha":
        hkv = 4
    elif case == "gqa_window":
        hq, s = 8, 384
        kw["window"] = (128, 0)
    elif case == "ragged":
        s = 200
    elif case == "offsets":
        s, skv = 120, 130
        j_extra = {"q_offset": jnp.int32(5), "kv_offset": jnp.int32(3)}
        t_extra = {"q_offset": 5, "kv_offset": 3}
    elif case == "noncausal":
        kw["is_causal"] = False
    else:
        kw.pop("block_q")
        kw.pop("block_kv")
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(30 + CASES.index(case), s, hq, hkv, skv=skv)
    with jconfig.patch({"attention.fp8_dot": True}):
        j_out = jflash(jq_, jk, jv, fused_block_quant=True, interpret=True, **kw, **j_extra)
    t_out = tflash(tq_, tk, tv, fused_block_quant=True, **kw, **t_extra)
    assert t_out.dtype == torch.bfloat16
    _close(j_out, t_out)


def test_block_sizes_follow_arguments_config_heuristic():
    for q_len, kv_len, d in ((100, 100, 64), (5000, 9000, 128), (700, 3000, 256), (8192, 8192, 512)):
        assert tflash_mod.heuristic_blocks(q_len, kv_len, d) == jflash_mod._heuristic_blocks(q_len, kv_len, d)
    assert tflash_mod.block_sizes(4096, 4096, 128) == (1024, 2048)
    with tconfig.patch({"kernel.block_q": 256, "kernel.block_kv": 512}):
        assert tflash_mod.block_sizes(4096, 4096, 128) == (256, 512)
        assert tflash_mod.block_sizes(4096, 4096, 128, block_q=64) == (64, 512)
    assert tflash_mod.block_sizes(100, 300, 256) == (128, 384)


@pytest.mark.parametrize("causal", [False, True])
def test_entry_points_per_block_match_jax(causal):
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(21, 192, 8, 2)
    with jconfig.patch({"interpret": True, "attention.fp8_dot": True}):
        j_out = qj.fp8_attn_func(jq_, jk, jv, is_causal=causal, scaling_method="per-block")
        j_fb = qj.fp8_attn_func_with_fallback(jq_, jk, jv, is_causal=causal,
                                              scaling_method="per-block")
    _close(j_out, qt.fp8_attn_func(tq_, tk, tv, is_causal=causal, scaling_method="per-block"))
    _close(j_fb, qt.fp8_attn_func_with_fallback(tq_, tk, tv, is_causal=causal,
                                                scaling_method="per-block"))
    # On CPU tensors "auto" takes per-block, untimed (JAX: interpret mode).
    with jconfig.patch({"interpret": True, "attention.fp8_dot": True}):
        j_auto = qj.fp8_attn_func(jq_, jk, jv, is_causal=causal, scaling_method="auto")
    _close(j_auto, qt.fp8_attn_func(tq_, tk, tv, is_causal=causal, scaling_method="auto"))


def _reason(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_refusals_match_jax():
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(5, 128, 2, 2)
    ts, js = torch.ones((1, 2)), jnp.ones((1, 2))
    for method in ("per-block", "auto"):
        assert (_reason(qt.fp8_attn_func, tq_, tk, tv, scaling_method=method, scale_q=ts, scale_k=ts)
                == _reason(qj.fp8_attn_func, jq_, jk, jv, scaling_method=method,
                           scale_q=js, scale_k=js))
    t8, j8 = tq_.to(torch.float8_e4m3fn), jq_.astype(jnp.float8_e4m3fn)
    assert (_reason(qt.fp8_attn_func, t8, t8, tv, scaling_method="auto")
            == _reason(qj.fp8_attn_func, j8, j8, jv, scaling_method="auto"))
    assert (_reason(tflash, t8, t8, tv, fused_block_quant=True)
            == _reason(jflash, j8, j8, jv, fused_block_quant=True, interpret=True))
    assert (_reason(tflash, tq_, tk, tv, fused_block_quant=True, scale_q=ts, scale_k=ts)
            == _reason(jflash, jq_, jk, jv, fused_block_quant=True, scale_q=js, scale_k=js,
                       interpret=True))


def test_per_block_beats_head_wise_on_an_outlier():
    """JAX's check (tests/test_fp8_flash.py:160-197) in the port, at its
    shape and default blocks: per-block within the 1e-2 RMSE bar against
    the fp32 oracle, and with one 30x outlier token within 1.2x of
    head-wise e4m3's RMSE (JAX compares with head-wise int8, a container
    the port does not have)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _arrays(9, [(2, 4, 512, 128)] * 3))

    def err(q, method):
        ref = sdpa_reference(q, k, v, is_causal=True, out_dtype=torch.float32)
        out = qt.fp8_attn_func(q, k, v, is_causal=True, scaling_method=method)
        return float(torch.sqrt(torch.mean((out.float() - ref) ** 2)))

    assert err(q, "per-block") < 1e-2
    q[0, 0, 10] *= 30.0
    assert err(q, "per-block") <= 1.2 * err(q, "head-wise")


def test_chunk_attention_per_block():
    """Chunked prefill under per-block: the chunk's Q and the gathered K
    quantized per block from the gathered K's row 0, with the offsets."""
    (q, k, v), _ = _qkv(13, 64, 4, 2, skv=200)
    pre_k, pre_v = k[:, :, :136], v[:, :, :136]
    out = backends._chunk_prefix_attend(q, k[:, :, 136:], v[:, :, 136:],
                                        lambda start: (pre_k[:, :, start:], pre_v[:, :, start:]),
                                        136, (100, 0), per_block=True)
    start = backends.prefix_start(136, (100, 0))
    want = tflash_mod.flash_attention_plain(q, k[:, :, start:], v[:, :, start:], is_causal=True,
                                            q_offset=136, kv_offset=start, window=(100, None),
                                            fused_block_quant=True)
    assert torch.equal(out, want)
    assert backends.chunk_per_block(llama.tiny(scaling_method="auto"))
    assert backends.chunk_per_block(llama.tiny(scaling_method="per-block"))
    assert not backends.chunk_per_block(llama.tiny())
    assert not backends.chunk_per_block(llama.tiny(scaling_method="per-block",
                                                   attention_impl="bf16"))
