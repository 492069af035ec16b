"""Sliding windows and position offsets in the port's kernels, on the CPU.

Every case holds the port against the JAX package on the same inputs, made
from numpy seeds; the JAX side runs its Pallas kernels in interpret mode, as
the JAX suite does.  Tolerances, each the bar of the file that holds the
same function without a window:

- ``sdpa_reference``: both in fp32 over the same fp32 inputs, 1e-5;
- K1's plain version against JAX's ``flash_attention``: both bf16, the JAX
  kernel rounding P to bf16 where the plain version keeps fp32: max
  |diff| <= 1/16 and RMSE < 2e-3 (tests/test_torch_flash.py); rows that see
  no key are exact zeros on both sides (JAX flash.py:573-578);
- K1's residuals: m within 2^-7 of its magnitude plus 1/64, l within 2%
  (tests/test_torch_flash_bwd.py);
- gradients: max|a - b| / max|b| < 2e-2, the JAX suite's bar
  (tests/test_autodiff.py:27-30);
- K4's plain version against JAX's ``decode_attention``: 1/64
  (tests/test_torch_decode.py); K10's against the DMA path of JAX's
  ``paged_decode_attention``: 1/32 (tests/test_torch_paged.py); empty
  slots exactly zero;
- ``tiny(window=16)``'s logits: relative Frobenius error < 2e-2
  (tests/test_torch_llama.py's bar for bf16 attention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu import config as jconfig
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.ops import autodiff as jautodiff
from quantumattention_tpu.ops import quant as jquant
from quantumattention_tpu.ops.decode import decode_attention as jdecode
from quantumattention_tpu.ops.flash import flash_attention as jflash
from quantumattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
from quantumattention_tpu.ops.sdpa import sdpa_reference as jsdpa
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import config as tconfig
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops import decode as tdec
from quantumattention_tpu_torch.ops import flash_bwd as tfb
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.autodiff import attention_with_vjp
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash
from quantumattention_tpu_torch.ops.paged import paged_decode_attention as tpaged
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference as tsdpa

K1_ATOL, K1_RMSE = 1.0 / 16, 2e-3
GRAD_BAR = 2e-2
K4_ATOL, K10_ATOL = 1.0 / 64, 1.0 / 32
LOGIT_REL = 2e-2
E4M3 = torch.float8_e4m3fn
CACHE_KINDS = ["int8", "e4m3", "int4", "bf16", "f16", "f32"]
FLOAT_TYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _j(t: torch.Tensor):
    """The same values as a jax array of the matching type."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8, torch.int32: jnp.int32,
           torch.float32: jnp.float32, torch.float16: jnp.float16, E4M3: jnp.float8_e4m3fn}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(jdt)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _pair(rng, shape, dtype=torch.bfloat16):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return t, _j(t)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------

WINDOWS = [(5, 0), (5, None), (None, 3), (4, 2), (0, 0), (None, None), (7, 3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_sdpa_reference_window_matches_jax(window, causal):
    rng = np.random.default_rng(3)
    (tq_, jq_), (tk, jk), (tv, jv) = (_pair(rng, s, torch.float32)
                                      for s in ((1, 4, 23, 32), (1, 2, 29, 32), (1, 2, 29, 32)))
    got = tsdpa(tq_, tk, tv, is_causal=causal, window=window)
    want = jsdpa(jq_, jk, jv, is_causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K1: window and offsets
# ---------------------------------------------------------------------------

# (causal, window, q_offset, kv_offset): causal windows with and without
# offsets, non-causal windows on both sides or one, and offsets that leave
# the first rows no key (zeros on both sides).
K1_CASES = [
    (True, (16, 0), 0, 0),
    (True, (24, 0), 40, 8),
    (True, (10, None), 50, 0),
    (False, (12, 5), 0, 0),
    (False, (None, 6), 10, 30),
    (False, (9, None), 0, 0),
]


def _k1_inputs(seed, sq=72, skv=100, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    return [_pair(rng, (1, h, s, d)) for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]


def _k1_close(want, got):
    a, b = _f32(want), _f32(got)
    assert a.shape == b.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=K1_ATOL, rtol=0)
    assert np.sqrt(np.mean((a - b) ** 2)) < K1_RMSE
    empty = np.abs(a).sum(-1) == 0
    np.testing.assert_array_equal(b[empty], 0.0)  # rows that see no key


@pytest.mark.parametrize("mode", ["bf16", "head", "token"])
@pytest.mark.parametrize("causal,window,q_off,kv_off", K1_CASES, ids=str)
def test_flash_window_offsets_match_jax(causal, window, q_off, kv_off, mode):
    (tq_, jq_), (tk, jk), (tv, jv) = _k1_inputs(q_off + kv_off + 1)
    kw_t = dict(is_causal=causal, window=window, q_offset=q_off, kv_offset=kv_off)
    kw_j = dict(is_causal=causal, window=window, q_offset=jnp.int32(q_off),
                kv_offset=jnp.int32(kv_off), interpret=True)
    if mode != "bf16":
        tfn = tq.quantize_head_wise if mode == "head" else tq.quantize_token_wise
        jfn = jquant.quantize_head_wise if mode == "head" else jquant.quantize_token_wise
        (tq_, tsq), (tk, tsk) = tfn(tq_), tfn(tk)
        (jq_, jsq), (jk, jsk) = jfn(jq_), jfn(jk)
        kw_t.update(scale_q=tsq, scale_k=tsk)
        kw_j.update(scale_q=jsq, scale_k=jsk)
    _k1_close(jflash(jq_, jk, jv, **kw_j), tflash(tq_, tk, tv, **kw_t))


def test_flash_window_residuals_match_jax():
    (tq_, jq_), (tk, jk), (tv, jv) = _k1_inputs(9, sq=96, skv=96)
    window = (20, 0)
    jo, (jm, jlse) = jflash(jq_, jk, jv, is_causal=True, window=window, return_residuals=True,
                            interpret=True)
    to, (tm, tlse) = tflash(tq_, tk, tv, is_causal=True, window=window, return_residuals=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm[..., 0]), rtol=2**-7, atol=1 / 64)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse[..., 0]), rtol=2e-2)
    _k1_close(jo, to)


def test_flash_kv_offset_is_a_cut_prefix():
    """K from position ``start`` on with kv_offset = start gives what the
    whole K gives, when the window hides the rows before ``start``."""
    (tq_, _), (tk, _), (tv, _) = _k1_inputs(4, sq=32, skv=160)
    q_off, left = 128, 40
    start = q_off - left
    full = tflash(tq_, tk, tv, is_causal=True, window=(left, 0), q_offset=q_off)
    cut = tflash(tq_, tk[:, :, start:], tv[:, :, start:], is_causal=True, window=(left, 0),
                 q_offset=q_off, kv_offset=start)
    torch.testing.assert_close(cut, full, atol=1.0 / 128, rtol=0)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["attn_func", "attn_func_with_fallback", "fp8_attn_func",
                                   "fp8_attn_func_with_fallback", "fp8_token_wise_attn_func",
                                   "fp8_token_wise_attn_func_with_fallback"])
def test_entry_points_window_match_jax(entry):
    (tq_, jq_), (tk, jk), (tv, jv) = _k1_inputs(11, sq=80, skv=80)
    window = (17, 0)
    got = getattr(qt, entry)(tq_, tk, tv, is_causal=True, window=window)
    with jconfig.patch({"interpret": True}):
        want = getattr(qj, entry)(jq_, jk, jv, is_causal=True, window=window)
    _k1_close(want, got)


def test_window_validation_reason_strings_match_jax():
    (tq_, jq_), (tk, jk), (tv, jv) = _k1_inputs(12, sq=16, skv=16)
    ok_t, why_t = qt.can_use_attention(tq_, tk, tv, is_causal=True, window=(4, 2))
    ok_j, why_j = qj.can_use_attention(jq_, jk, jv, is_causal=True, window=(4, 2))
    assert not ok_t and not ok_j
    assert why_t == "[cuda: is_causal with a right window extent is contradictory]"
    assert why_j.replace("[pallas: ", "[cuda: ") == why_t
    for ok_window in ((4, 0), (4, None), (None, None)):
        assert qt.can_use_attention(tq_, tk, tv, is_causal=True, window=ok_window) == (True, "")
    assert qt.can_use_attention(tq_, tk, tv, is_causal=False, window=(4, 2)) == (True, "")
    with pytest.raises(ValueError, match="contradictory"):
        qt.attn_func(tq_, tk, tv, is_causal=True, window=(4, 2))
    with pytest.raises(ValueError, match="contradictory"):
        qt.fp8_attn_func(tq_, tk, tv, is_causal=True, window=(4, 2))
    # The fallback serves what the kernel refuses, as JAX's does.
    before = qt.dispatch.sdpa_fallback.calls
    got = qt.attn_func_with_fallback(tq_, tk, tv, is_causal=True, window=(4, 2))
    assert qt.dispatch.sdpa_fallback.calls == before + 1
    want = qj.attn_func_with_fallback(jq_, jk, jv, is_causal=True, window=(4, 2))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1.0 / 64)
    with pytest.raises(ValueError, match="window"):
        tflash(tq_, tk, tv, window=(4,))
    with pytest.raises(ValueError, match="kv_offset"):
        tflash(tq_, tk, tv, kv_offset=-1)


# ---------------------------------------------------------------------------
# Gradients (K2/K3 plain versions and the autograd Function)
# ---------------------------------------------------------------------------


def test_window_grads_match_jax():
    """The mirror of JAX tests/test_autodiff.py:121 (GQA 8/2, S = 256,
    window (96, 0), causal): the port's Function (K1 + K2/K3 plain
    versions) against jax.grad through JAX's Pallas backward, and the port's
    two backwards against each other."""
    rng = np.random.default_rng(4)
    (tq_, jq_), (tk, jk), (tv, jv) = (_pair(rng, (1, h, 256, 64)) for h in (8, 2, 2))
    window = (96, 0)

    def jloss(q, k, v):
        with jconfig.patch({"kernel.pallas_bwd": True, "interpret": True}):
            out = jautodiff.attention_with_vjp(q, k, v, is_causal=True, window=window,
                                               block_q=128, block_kv=128)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq_, jk, jv)
    tgrads = {}
    for flag in (True, False):
        leaves = [t.clone().requires_grad_() for t in (tq_, tk, tv)]
        with tconfig.patch({"kernel.cuda_bwd": flag}):
            out = attention_with_vjp(*leaves, is_causal=True, window=window)
            out.float().pow(2).sum().backward()
        tgrads[flag] = [t.grad for t in leaves]
    for tg, og, jg, name in zip(tgrads[True], tgrads[False], jgrads, "qkv"):
        assert rel_err(_f32(tg), _f32(jg)) < GRAD_BAR, f"d{name} vs JAX"
        assert rel_err(_f32(tg), _f32(og)) < GRAD_BAR, f"d{name} vs the oracle's VJP"


@pytest.mark.parametrize("causal,window", [(True, (40, 0)), (False, (30, 12)), (False, (None, 20))],
                         ids=str)
def test_window_bwd_kernels_match_jax(causal, window):
    """K2/K3's plain versions with a window against JAX's Pallas backward
    on the same (q, k, v, o, dO, m, l)."""
    rng = np.random.default_rng(6)
    (tq_, jq_), (tk, jk), (tv, jv) = (_pair(rng, (1, h, 160, 64)) for h in (4, 2, 2))
    jo, (jm, jlse) = jflash(jq_, jk, jv, is_causal=causal, window=window, return_residuals=True,
                            interpret=True)
    tdo, jdo = _pair(rng, (1, 4, 160, 64))
    to = torch.from_numpy(np.array(_f32(jo))).to(torch.bfloat16)
    tm, tlse = (torch.from_numpy(np.array(x[..., 0])) for x in (jm, jlse))
    jgrads = jbwd(jq_, jk, jv, jo, jdo, jm, jlse, is_causal=causal, window=window)
    tgrads = tfb.flash_attention_bwd(tq_, tk, tv, to, tdo, tm, tlse, is_causal=causal,
                                     window=window)
    for tg, jg, t, name in zip(tgrads, jgrads, (tq_, tk, tv), "qkv"):
        assert tg.shape == t.shape and tg.dtype == t.dtype, name
        assert rel_err(_f32(tg), _f32(jg)) < GRAD_BAR, f"d{name}"


# ---------------------------------------------------------------------------
# K4 and K10: window over every cache kind, T = 1 and verify
# ---------------------------------------------------------------------------

B, HKV, D, SMAX = 3, 2, 64, 256


def _rows(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _cache(kind, k, v, pages=False):
    """(k, v, k_scale, v_scale) of float rows in the cache type ``kind``
    (int4 packed along the head dim, or along a page's tokens for pages)."""
    if kind in FLOAT_TYPES:
        return k.to(FLOAT_TYPES[kind]), v.to(FLOAT_TYPES[kind]), None, None
    if kind == "int4" and pages:
        (kc, ks), (vc, vs) = (tq.quantize_int4_values(x, reduction_dim=-1) for x in (k, v))
        return tq.pack_int4(kc, axis=2), tq.pack_int4(vc, axis=2), ks, vs
    fn = {"int8": tq.dynamically_quantize_int8, "e4m3": tq.dynamically_quantize_fp8,
          "int4": tq.dynamically_quantize_int4}[kind]
    (kc, ks), (vc, vs) = fn(k, reduction_dim=-1), fn(v, reduction_dim=-1)
    return kc, vc, ks, vs


def _close(got, want, atol, empty):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(_f32(want)))
    assert got.shape == want.shape
    for i in empty:
        assert torch.equal(got[i], torch.zeros_like(got[i]))
    assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.parametrize("window", [(16, 0), (100, None)], ids=str)
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_decode_window_matches_jax(kind, t, window):
    rng = np.random.default_rng(t + 7 * CACHE_KINDS.index(kind))
    shape = (B, HKV * 4, D) if t == 1 else (B, HKV * 4, t, D)
    q = _rows(rng, shape).to(torch.bfloat16)
    kc, vc, ks, vs = _cache(kind, _rows(rng, (B, HKV, SMAX, D)), _rows(rng, (B, HKV, SMAX, D)))
    lens = torch.tensor([0, 37, 200], dtype=torch.int32)
    got = tdec.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs, window=window)
    want = jdecode(_j(q), _j(kc), _j(vc), _j(lens), k_scale=None if ks is None else _j(ks),
                   v_scale=None if vs is None else _j(vs), window=window, interpret=True)
    _close(got, want, K4_ATOL, empty=(0,))
    full = tdec.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    assert not torch.equal(got[2], full[2])  # the window bites at length 200


@pytest.mark.parametrize("window", [(20, 0), (70, None)], ids=str)
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_paged_window_matches_jax_dma_kernel(kind, t, window):
    rng = np.random.default_rng(31 + t + 7 * CACHE_KINDS.index(kind))
    ps, pps = 32, 4
    pool = B * pps + 3
    k, v, ks, vs = _cache(kind, _rows(rng, (HKV, pool, ps, D)), _rows(rng, (HKV, pool, ps, D)),
                          pages=True)
    table = torch.from_numpy(rng.permutation(pool)[: B * pps].reshape(B, pps).astype(np.int32))
    shape = (B, HKV * 4, D) if t == 1 else (B, HKV * 4, t, D)
    q = _rows(rng, shape).to(torch.bfloat16)
    lens = torch.tensor([pps * ps - 5, 0, 50], dtype=torch.int32)
    got = tpaged(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs, pages_per_block=2,
                 window=window)
    want = jpaged(_j(q), _j(k), _j(v), _j(lens), _j(table),
                  k_scale_pages=None if ks is None else _j(ks),
                  v_scale_pages=None if vs is None else _j(vs), pages_per_block=2,
                  window=window, use_dma=True, interpret=True)
    _close(got, want, K10_ATOL, empty=(1,))


def test_decode_window_validation_matches_jax():
    rng = np.random.default_rng(0)
    q = _rows(rng, (B, 4, D)).to(torch.bfloat16)
    kc = _rows(rng, (B, HKV, SMAX, D)).to(torch.bfloat16)
    lens = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="must be \\(left, 0\\)") as t_err:
        tdec.decode_attention(q, kc, kc, lens, window=(4, 2))
    with pytest.raises(ValueError, match="must be \\(left, 0\\)") as j_err:
        jdecode(_j(q), _j(kc), _j(kc), _j(lens), window=(4, 2), interpret=True)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="left extent"):
        tdec.decode_attention(q, kc, kc, lens, window=(-1, 0))
    none = tdec.decode_attention(q, kc, kc, lens, window=(None, 0))
    assert torch.equal(none, tdec.decode_attention(q, kc, kc, lens))


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("left", [0, 63, 64, 255, 1023, 4095])
def test_decode_schedule_starts_at_the_first_window_tile(left, t):
    """A slot's tiles run from the one that holds candidate 0's first
    in-window row to its last row; no tile below it is scheduled, every
    in-window row is, and each CTA's share stays balanced."""
    lens = np.asarray([0, 1, 57, 64, 900, 2047, 4100, 8192])
    sched = tdec.decode_schedule(lens, 8, tdec.ROWS_PER_TILE, 132, 8192, window_left=left,
                                 qtokens=t)
    whole = tdec.decode_schedule(lens, 8, tdec.ROWS_PER_TILE, 132, 8192)
    for n, first, tiles, all_tiles in zip(lens, sched.first, sched.tiles, whole.tiles):
        lo = max(0, int(n) - t - left)  # candidate 0's first row
        assert first == lo // 64 and first + tiles == all_tiles
        assert first * 64 <= lo < max(first + 1, 1) * 64 or n == 0
    assert sched.total <= whole.total
    counts = [u1 - u0 for u0, u1 in map(sched.cta_tiles, range(sched.active))]
    assert max(counts) - min(counts) <= 1 and sum(counts) == sched.total
    for c in range(sched.ctas):
        for seg, a, b in sched.runs(c):
            assert 0 <= a < b <= sched.tiles[seg // 8]
    if left == 4095 and t == 1:
        # Mistral's window over an 8192-row slot: 64 of its 128 tiles.
        assert sched.tiles[-1] == 64 and whole.tiles[-1] == 128


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_mistral_7b_fields_match_jax():
    t, j = tl.mistral_7b(), jl.mistral_7b()
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_q_heads",
                  "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps", "window",
                  "tie_embeddings", "qkv_bias", "num_experts"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.window == 4096 and tl.window_of(t) == (4095, 0)
    assert tl.mistral_7b(num_layers=2).num_layers == 2


@pytest.mark.parametrize("impl", ["bf16", "fp8", "sdpa"])
def test_tiny_window_forward_matches_jax(impl):
    jcfg, tcfg = jl.tiny(window=16, attention_impl=impl), tl.tiny(window=16, attention_impl=impl)
    jp = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, 256, (2, 48)).astype(np.int32)
    with jconfig.patch({"interpret": True}):
        want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jcfg), np.float32)
    got = tl.forward(tp, torch.from_numpy(tokens).long(), tcfg).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < LOGIT_REL
    full = tl.forward(tp, torch.from_numpy(tokens).long(), tl.tiny(attention_impl=impl)).numpy()
    assert np.linalg.norm(full[:, 20:] - got[:, 20:]) > 10 * np.linalg.norm(got - want)
