"""Every head dim the JAX package takes, through the port, against the JAX package.

JAX admits any multiple of 8 up to 512 besides 64/128/256
(quantumattention_tpu/dispatch.py:98-102); so does the port, whose kernels
run such a width at an instantiated one (64, 128, 256, 512) with zero
columns.  On the CPU the port's wrappers run their plain versions; the JAX
side runs its Pallas kernels in interpret mode (the paged kernel through its
DMA path, ``use_dma=True``), as the JAX suite does.  Inputs are made from
numpy seeds at small sizes (S <= 48, few heads: interpret mode is slow at
wide heads).

Tolerances, as tests/test_torch_widths.py states them:
  * forward (bf16 outputs): ATOL = 1/16 (a couple of bf16 ulps of values
    below 4: the JAX kernel rounds P to bf16 and pre-scales q in bf16 where
    the plain version keeps fp32) and RMSE < 2e-3, a fifth of the
    repository's 1e-2 bar;
  * gradients: max|a - b| / max|b| < 2e-2, the JAX suite's bar
    (tests/test_autodiff.py:27-30);
  * paged decode and decode (K10's and K4's plain versions): RMSE < 1e-2
    and max |diff| <= 1/32;
  * the padded-column helper: the padded inputs give the unpadded output to
    fp32 rounding (atol 1e-6: zero columns add exact zeros, the summation
    order of the wider product may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu import dispatch as jdispatch
from quantumattention_tpu.ops import quant as jq
from quantumattention_tpu.ops.flash import flash_attention as jflash
from quantumattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd
from quantumattention_tpu.ops.decode import decode_attention as jdecode
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import dispatch as tdispatch
from quantumattention_tpu_torch.ops import flash_bwd as tfb
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.flash import (
    flash_attention as tflash,
    flash_attention_plain,
    pad_8bit_columns,
)
from quantumattention_tpu_torch.ops.decode import decode_attention as tdecode
from quantumattention_tpu_torch.ops.paged import paged_decode_attention
from quantumattention_tpu_torch.utils import shapes

ATOL = 1.0 / 16
RMSE_MAX = 2e-3
GRAD_BAR = 2e-2
PAGED_ATOL = 1.0 / 32
PAGED_RMSE = 1e-2
WIDTHS = [72, 96, 160, 320, 512]


def _qkv(seed, s, d, hq=4, hkv=2):
    """The same bf16 (q, k, v) values for each framework."""
    rng = np.random.default_rng(seed)
    tt = [torch.from_numpy(rng.standard_normal((1, h, s, d)).astype(np.float32)).to(torch.bfloat16)
          for h in (hq, hkv, hkv)]
    jj = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tt]
    return tt, jj


def _close(j_out, t_out):
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    assert np.sqrt(np.mean((a - b) ** 2)) < RMSE_MAX


@pytest.mark.parametrize("mode", ["bf16", "head", "token"])
@pytest.mark.parametrize("d", WIDTHS)
def test_flash_any_width_matches_jax(d, mode):
    """K1's plain version against JAX's flash_attention, causal, GQA."""
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(d, 40, d)
    if mode == "bf16":
        j_out = jflash(jq_, jk, jv, is_causal=True)
        t_out = tflash(tq_, tk, tv, is_causal=True)
    else:
        jfn = jq.quantize_head_wise if mode == "head" else jq.quantize_token_wise
        tfn = tq.quantize_head_wise if mode == "head" else tq.quantize_token_wise
        (jq8, jsq), (jk8, jsk) = jfn(jq_), jfn(jk)
        (tq8, tsq), (tk8, tsk) = tfn(tq_), tfn(tk)
        j_out = jflash(jq8, jk8, jv, scale_q=jsq, scale_k=jsk, is_causal=True)
        t_out = tflash(tq8, tk8, tv, scale_q=tsq, scale_k=tsk, is_causal=True)
    assert t_out.dtype == torch.bfloat16 and t_out.shape == (1, 4, 40, d)
    _close(j_out, t_out)


ENTRY_POINTS = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
@pytest.mark.parametrize("d", [96, 320])
def test_entry_points_any_width_match_jax(d, name):
    """The six entry points take D = 96 and 320 on the fused path, as JAX's do."""
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(100 + d, 48, d)
    before = tdispatch.sdpa_fallback.calls
    _close(getattr(qj, name)(jq_, jk, jv, is_causal=True),
           getattr(qt, name)(tq_, tk, tv, is_causal=True))
    assert tdispatch.sdpa_fallback.calls == before


#: Head dims of the validation sweep: every multiple of 8 up to 520, and a
#: few that are not multiples of 8.
SWEEP = list(range(8, 521, 8)) + [4, 12, 36, 100, 130, 511, 513, 1000]


@pytest.mark.parametrize("d", SWEEP)
def test_validation_sweep_matches_jax(d):
    """validate_flash_input and can_use_attention give JAX's (ok, reason)
    for every width; the port brackets its reason as [cuda: ...] where JAX
    writes [pallas: ...]."""
    shapes_ = [(1, 4, 8, d), (1, 2, 8, d), (1, 2, 8, d)]
    j_res = jdispatch.validate_flash_input(*(jnp.zeros(s, jnp.bfloat16) for s in shapes_))
    targs = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes_]
    assert tdispatch.validate_flash_input(*targs) == j_res
    assert j_res[0] == shapes.head_dim_supported(d) == (d % 8 == 0 and d <= 512)
    j_can = qj.can_use_attention(*(jnp.zeros(s, jnp.bfloat16) for s in shapes_))
    t_can = qt.can_use_attention(*targs)
    assert t_can == (j_can[0], j_can[1].replace("[pallas: ", "[cuda: "))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [96, 320])
def test_bwd_any_width_matches_jax(d, causal):
    """K2/K3's plain versions against JAX's blockwise backward, GQA (4 q
    heads over 2 KV heads), on the JAX forward's (o, m, l)."""
    rng = np.random.default_rng(d + causal)

    def pair(shape):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    (tq_, jq_), (tk, jk), (tv, jv), (tdo, jdo) = (pair((1, h, 40, d)) for h in (4, 2, 2, 4))
    jo, (jm, jl) = jflash(jq_, jk, jv, is_causal=causal, return_residuals=True)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(torch.bfloat16)
    tm, tl = (torch.from_numpy(np.array(x[..., 0])) for x in (jm, jl))
    jgrads = jbwd(jq_, jk, jv, jo, jdo, jm, jl, is_causal=causal)
    tgrads = tfb.flash_attention_bwd(tq_, tk, tv, to, tdo, tm, tl, is_causal=causal)
    for tg, jg, t, name in zip(tgrads, jgrads, (tq_, tk, tv), "qkv"):
        a = tg.float().numpy().astype(np.float64)
        b = np.asarray(jg.astype(jnp.float32), np.float64)
        assert tg.shape == t.shape and tg.dtype == t.dtype, name
        assert np.abs(a - b).max() / np.abs(b).max() < GRAD_BAR, f"d{name}"


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_paged_d96_matches_jax_dma_kernel(kind):
    """K10's plain version against JAX's DMA kernel at D = 96, a shuffled
    table, a ragged and an empty slot."""
    b, hkv, group, ps, pps, d = 2, 2, 4, 16, 3, 96
    rng = np.random.default_rng(96)
    num_pages = b * pps + 1
    kf = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    vf = rng.standard_normal((hkv, num_pages, ps, d)).astype(np.float32)
    table = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((b, hkv * group, d)).astype(np.float32)).to(torch.bfloat16)
    if kind == "int8":
        k8, ks = tq.dynamically_quantize_int8(torch.from_numpy(kf), reduction_dim=-1)
        v8, vs = tq.dynamically_quantize_int8(torch.from_numpy(vf), reduction_dim=-1)
        pages = (k8, v8, ks, vs)
        jpages = tuple(jnp.asarray(x.numpy()) for x in pages)
    else:
        k16, v16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (kf, vf))
        pages = (k16, v16, None, None)
        jpages = tuple(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (k16, v16))
        jpages += (None, None)
    lengths = np.asarray([pps * ps - 7, 0], np.int32)
    got = paged_decode_attention(q, pages[0], pages[1], torch.from_numpy(lengths),
                                 torch.from_numpy(table), k_scale_pages=pages[2],
                                 v_scale_pages=pages[3], pages_per_block=1)
    jqv = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    want = jpaged(jqv, jpages[0], jpages[1], jnp.asarray(lengths), jnp.asarray(table),
                  k_scale_pages=jpages[2], v_scale_pages=jpages[3], pages_per_block=1,
                  use_dma=True, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv * group, d)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    diff = got.float() - want
    assert float(diff.abs().max()) <= PAGED_ATOL
    assert float(diff.pow(2).mean().sqrt()) < PAGED_RMSE


@pytest.mark.parametrize("mode", ["e4m3-head", "e4m3-token", "int8-head"])
@pytest.mark.parametrize("d", [72, 88, 200])
def test_padded_columns_give_the_same_output(d, mode):
    """8-bit Q/K of D % 16 == 8 go to K1 zero-padded to the next multiple of
    16 columns (a tensor map's 16-byte row rule): the padded operands give
    the unpadded output in their first D columns, and the residuals."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, 33, d)).astype(np.float32)).to(torch.bfloat16)
               for h in (4, 2, 2))
    qdt = torch.int8 if mode.startswith("int8") else torch.float8_e4m3fn
    fn = tq.quantize_head_wise if mode.endswith("head") else tq.quantize_token_wise
    (q8, sq), (k8, sk) = fn(q, qdt), fn(k, qdt)
    pq, pk, pv = pad_8bit_columns(q8, k8, v)
    assert pq.shape[-1] == pk.shape[-1] == pv.shape[-1] == shapes.round_up(d, 16)
    assert pq.dtype == qdt and pv.dtype == v.dtype
    assert torch.equal(pq[..., :d].view(torch.uint8), q8.view(torch.uint8))
    assert not pq[..., d:].float().any() and not pv[..., d:].float().any()
    kw = dict(scale_q=sq, scale_k=sk, is_causal=True, sm_scale=d ** -0.5, return_residuals=True)
    want, (wm, wl) = flash_attention_plain(q8, k8, v, **kw)
    got, (gm, gl) = flash_attention_plain(pq, pk, pv, **kw)
    torch.testing.assert_close(got[..., :d].float(), want.float(), atol=1e-6, rtol=0)
    assert not got[..., d:].float().any()
    torch.testing.assert_close(gm, wm, atol=1e-6, rtol=0)
    torch.testing.assert_close(gl, wl, atol=0, rtol=1e-6)
    # 16-bit operands, and 8-bit ones of a 16-multiple width, are left as they are.
    assert pad_8bit_columns(q, k, v)[0] is q
    q16 = fn(q[..., :64].contiguous(), qdt)[0]
    assert pad_8bit_columns(q16, q16, q16)[0] is q16


def test_pack_stats_rows():
    """K2/K3's per-row statistics: (m, 1/l, D, 0) rows, 1/l = 0 where l = 0
    (rows no key reaches), zero rows from Sq up to the next multiple of 64."""
    rng = np.random.default_rng(7)
    m, l, delta = (torch.from_numpy(rng.standard_normal((2, 3, 70)).astype(np.float32)) for _ in range(3))
    l = l.abs()
    l[0, 1, 5] = 0.0
    stats = tfb.pack_stats(m, l, delta)
    assert stats.shape == (2, 3, 128, 4) and stats.dtype == torch.float32
    torch.testing.assert_close(stats[:, :, :70, 0], m, atol=0, rtol=0)
    torch.testing.assert_close(stats[:, :, :70, 2], delta, atol=0, rtol=0)
    want_inv = torch.where(l == 0, 0.0, 1.0 / l)
    torch.testing.assert_close(stats[:, :, :70, 1], want_inv, atol=0, rtol=0)
    assert float(stats[0, 1, 5, 1]) == 0.0
    assert not stats[:, :, 70:].any() and not stats[..., 3].any()


def _decode_inputs(seed, d, kind, b=3, hq=4, hkv=2, s_max=96):
    """The same decode inputs for each framework: bf16 q, an int8 cache
    with token scales or a bf16 cache, lengths with an empty slot."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)) for _ in range(2))
    if kind == "int8":
        (kc, ks), (vc, vs) = (tq.dynamically_quantize_int8(x, reduction_dim=-1) for x in (k, v))
        jc = [jnp.asarray(x.numpy()) for x in (kc, vc, ks, vs)]
    else:
        kc, vc, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
        jc = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (kc, vc)] + [None, None]
    lengths = np.asarray([0, s_max - 5, 17][:b], np.int32)
    jq_ = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    return (q, kc, vc, torch.from_numpy(lengths), ks, vs), (jq_, *jc[:2], jnp.asarray(lengths), *jc[2:])


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("d", [72, 96, 320, 512])
def test_decode_any_width_matches_jax(d, kind):
    """K4's plain version against JAX's decode_attention (interpret mode),
    GQA (4 q heads over 2), an empty slot; tolerance as K10's above (both
    round P, times the V scale, to bf16; the JAX kernel's running maximum
    moves block by block)."""
    (q, kc, vc, lengths, ks, vs), (jq_, jk, jv, jl, jks, jvs) = _decode_inputs(d, d, kind)
    got = tdecode(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
    want = jdecode(jq_, jk, jv, jl, k_scale=jks, v_scale=jvs, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    diff = got.float() - want
    assert float(diff.abs().max()) <= PAGED_ATOL
    assert float(diff.pow(2).mean().sqrt()) < PAGED_RMSE


#: Head dims of the decode sweep: multiples of 8 between and at the
#: instantiated widths, the edge past 512, and widths that are not
#: multiples of 8.
DECODE_SWEEP = [8, 16, 24, 56, 64, 72, 120, 128, 136, 248, 256, 264, 320, 504, 512, 520, 4, 12, 100, 1000]


@pytest.mark.parametrize("d", DECODE_SWEEP)
def test_decode_width_sweep_matches_jax(d):
    """Which head dims decode attention takes.  JAX's decode_attention
    checks none: its Pallas kernel (here in interpret mode) computes any
    width, and so does K4's plain version on the CPU; both agree on the
    values.  On the card K4 takes exactly the widths JAX's attention
    validation takes (validate_flash_input: a multiple of 8 up to 512), the
    widths K1, K2, K3 and K10 take; it refuses the rest before launching."""
    (q, kc, vc, lengths, _, _), (jq_, jk, jv, jl, _, _) = _decode_inputs(d, d, "bf16", b=2, hq=2, hkv=1, s_max=16)
    got = tdecode(q, kc, vc, lengths)
    want = np.array(jdecode(jq_, jk, jv, jl, interpret=True).astype(jnp.float32))
    assert got.shape == q.shape and want.shape == tuple(q.shape)
    np.testing.assert_allclose(got.float().numpy(), want, atol=PAGED_ATOL, rtol=0)
    shapes_ = [(1, 2, 8, d), (1, 1, 8, d), (1, 1, 8, d)]
    jax_takes = jdispatch.validate_flash_input(*(jnp.zeros(s, jnp.bfloat16) for s in shapes_))[0]
    try:
        shapes.check_kernel_head_dim("K4", d)
        kernel_takes = True
    except ValueError:
        kernel_takes = False
    assert kernel_takes == jax_takes == (d % 8 == 0 and d <= 512)
