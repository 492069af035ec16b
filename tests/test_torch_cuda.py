"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture) where no
CUDA device is present, so on a CPU-only machine they count as skipped.
On a machine with the card and without JAX, run them alone, without the
JAX test bootstrap:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: kernel and plain version both round P and the output to bf16
(or fp16) and sum in other orders, so they may differ by a couple of
half-precision ulps of values below 2 (ATOL = 1/32); the RMSE against the
fp32 oracle on the same (dequantized) inputs must stay under the
repository's 1e-2 bar.  The backward kernels round P and dS to bf16 where
their plain version keeps fp32: gradients are held to max|a - b| / max|b|
< 2e-2, the JAX suite's bar (tests/test_autodiff.py:27-30).  Their shapes
replace the one-key problem (Sq = Skv = 1), whose dQ and dK vanish exactly
and leave only rounding to compare, by Sq = Skv = 3.  K1's residuals are the same fp32 scores summed in
another order: m to 1e-3 and l to 1e-3 relative for bf16 inputs; the
backward's fp16 cases keep the 3e-2 of the earlier K1, which rounded fp16
to bf16 (K1 now multiplies fp16 in fp16; K2 and K3 still round it).  fp32
inputs enter K1 rounded to bf16 (ops/flash.py), so their residuals are
held against the plain version on the rounded inputs, and their outputs
against the fp32 oracle within the 1e-2 RMSE bar.  e4m3 Q/K multiply on
the tensor cores in e4m3, whose wgmma sums products with fewer bits than
fp32 (about 14: the DeepSeek-V3 report, section 3.3.2), a relative error
near 2^-11 of a score: their residuals are held to m within 1/128 and l
within 1e-2 relative (twice the error seen at Llama-3-8B's prefill shape).
K4 and K10 (decode attention) are held tighter: a long slot's outputs on
unit-normal inputs are about 0.05, as small as 1/32.  Their largest
differences from the plain version on the card were 1/256 at D <= 256 and
1/128 at D 320/512, so they are held to max|a - b| within 1/64 and, within
each non-empty slot, max|a - b| / max|b| within 2^-6 and
rmse(a, b) / rms(b) under 1e-2.
"""

import numpy as np
import pytest
import torch

import quantumattention_tpu_torch as qt

from quantumattention_tpu_torch.models import llama
from quantumattention_tpu_torch.ops import flash as flash_mod
from quantumattention_tpu_torch.ops import quant
from quantumattention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
from quantumattention_tpu_torch.ops.flash import flash_attention, flash_attention_plain, to_16bit
from quantumattention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.utils import checks

pytestmark = pytest.mark.cuda
ATOL = 1.0 / 32
RMSE_BAR = 1e-2
GRAD_BAR = 2e-2
FP8_RESIDUAL_M_ATOL = 1.0 / 128
FP8_RESIDUAL_L_RTOL = 1e-2
DECODE_ATOL = 1.0 / 64
DECODE_SLOT_MAX_REL = 2.0 ** -6
DECODE_SLOT_RMS_REL = 1e-2


def _assert_decode_close(out, plain, lens):
    """K4's or K10's (B, Hq, D) output against its plain version, within
    the decode bars overall and in every slot of non-zero length."""
    diff = out.float() - plain.float()
    assert float(diff.abs().max()) <= DECODE_ATOL
    for i, n in enumerate(lens.tolist()):
        if n:
            ref = plain[i].float()
            assert float(diff[i].abs().max() / ref.abs().max()) <= DECODE_SLOT_MAX_REL, i
            assert float(diff[i].pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()) < DECODE_SLOT_RMS_REL, i


@pytest.fixture
def cuda():
    if not checks.cuda_available():
        pytest.skip("needs a CUDA device")
    if not checks.is_hopper(0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dtype, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


FLASH_SHAPES = [  # (B, Hq, Hkv, Sq, Skv, D, causal)
    (2, 4, 4, 1, 1, 64, True),
    (1, 8, 2, 65, 65, 128, True),
    (1, 4, 1, 100, 37, 64, False),
    (1, 4, 2, 37, 100, 128, True),
    (3, 6, 3, 129, 130, 64, True),
    (1, 2, 2, 300, 300, 128, False),
]
FLASH_MODES = ["bf16", "fp16", "e4m3-head", "e4m3-token", "int8-head", "int8-token", "e4m3-v"]


@pytest.mark.parametrize("mode", FLASH_MODES)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain(cuda, shape, mode):
    b, hq, hkv, sq, skv, d, causal = shape
    fdt = torch.float16 if mode == "fp16" else torch.bfloat16
    q = _randn((b, hq, sq, d), 1, fdt, cuda)
    k = _randn((b, hkv, skv, d), 2, fdt, cuda)
    v = _randn((b, hkv, skv, d), 3, fdt, cuda)
    scales = {}
    if mode in ("e4m3-v",):
        v = v.to(torch.float8_e4m3fn)
    elif mode not in ("bf16", "fp16"):
        qdt = torch.float8_e4m3fn if mode.startswith("e4m3") else torch.int8
        fn = quant.quantize_head_wise if mode.endswith("head") else quant.quantize_token_wise
        q, sq_ = fn(q, qdt)
        k, sk_ = fn(k, qdt)
        scales = {"scale_q": sq_, "scale_k": sk_}
    before = flash_attention.launches
    out = flash_attention(q, k, v, is_causal=causal, **scales)
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, is_causal=causal, **scales)
    oracle = sdpa_reference(q, k, v, is_causal=causal, out_dtype=torch.float32, **scales)
    torch.cuda.synchronize()
    assert out.dtype == plain.dtype and out.shape == plain.shape
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - plain.float()).abs().max()) <= ATOL
    assert float(torch.sqrt(torch.mean((out.float() - oracle) ** 2))) < RMSE_BAR


K1_WIDTH_MODES = ["bf16", "fp16", "e4m3-head", "e4m3-token", "int8-head", "e4m3-v", "fp32"]
K1_WIDTH_SHAPES = [  # (B, Hq, Hkv, Sq, Skv, q_offset): G 1, 4, 8; Sq < Skv with offsets 0, 130
    (1, 2, 2, 1, 1, 0),
    (2, 4, 1, 3, 3, 0),
    (1, 8, 1, 57, 57, 0),
    (1, 4, 4, 200, 200, 0),
    (1, 8, 2, 100, 357, 0),
    (1, 8, 1, 100, 357, 130),
]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", K1_WIDTH_MODES)
@pytest.mark.parametrize("shape", K1_WIDTH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_widths_and_types(cuda, d, shape, mode, causal):
    """K1 over head dims 64/128/256 and every operand type against its
    plain version and the fp32 oracle; the output is the same with and
    without residuals, and the residuals match their plain version."""
    _k1_width_case(cuda, d, shape, mode, causal)


def _k1_width_case(cuda, d, shape, mode, causal):
    b, hq, hkv, sq, skv, off = shape
    fdt = {"fp16": torch.float16, "fp32": torch.float32}.get(mode, torch.bfloat16)
    q = _randn((b, hq, sq, d), 31, fdt, cuda)
    k = _randn((b, hkv, skv, d), 32, fdt, cuda)
    v = _randn((b, hkv, skv, d), 33, fdt, cuda)
    scales = {}
    if mode == "e4m3-v":
        v = v.to(torch.float8_e4m3fn)
    elif mode not in ("bf16", "fp16", "fp32"):
        qdt = torch.float8_e4m3fn if mode.startswith("e4m3") else torch.int8
        fn = quant.quantize_head_wise if mode.endswith("head") else quant.quantize_token_wise
        q, sq_ = fn(q, qdt)
        k, sk_ = fn(k, qdt)
        scales = {"scale_q": sq_, "scale_k": sk_}
    before = flash_attention.launches
    out = flash_attention(q, k, v, is_causal=causal, q_offset=off, **scales)
    with_res, (m, l) = flash_attention(q, k, v, is_causal=causal, q_offset=off,
                                       return_residuals=True, **scales)
    assert flash_attention.launches == before + 2
    plain = flash_attention_plain(q, k, v, is_causal=causal, q_offset=off, **scales)
    rounded = [to_16bit(t) for t in (q, k, v)]
    _, (pm, pl) = flash_attention_plain(*rounded, is_causal=causal, q_offset=off,
                                        return_residuals=True, **scales)
    mask = None
    if causal:
        rows = torch.arange(sq, device=cuda)[:, None] + off
        mask = torch.arange(skv, device=cuda)[None, :] <= rows
    oracle = sdpa_reference(q, k, v, attn_mask=mask, out_dtype=torch.float32, **scales)
    torch.cuda.synchronize()
    assert out.dtype == plain.dtype == (torch.float32 if mode == "fp32" else fdt)
    assert torch.equal(out, with_res)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - plain.float()).abs().max()) <= ATOL
    assert float(torch.sqrt(torch.mean((out.float() - oracle) ** 2))) < RMSE_BAR
    fp8_qk = mode in ("e4m3-head", "e4m3-token")
    m_bar, l_bar = (FP8_RESIDUAL_M_ATOL, FP8_RESIDUAL_L_RTOL) if fp8_qk else (1e-3, 1e-3)
    assert float((m - pm).abs().max()) <= m_bar
    assert float(((l - pl).abs() / pl).max()) <= l_bar


#: (GQA group, head dim) of K4's card cases: groups 1-16 and one of 32
#: (split over two segments; the parent kernel took it), head dims at and
#: between the instantiated widths (fault 9: D >= 432 overflowed the parent's
#: fp32 shared-memory tiles).
DECODE_CASES = [(1, 64), (4, 128), (8, 64), (16, 128), (32, 128), (4, 72), (1, 96), (8, 320),
                (4, 432), (4, 512), (16, 512)]
#: Slot lengths across the core's 16-row boxes, 64-row tiles and shares.
DECODE_LENGTHS = [0, 1, 63, 64, 65, 256, 257, 600]


FLOAT_CACHES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _decode_case(cuda, cache, group, d, hkv=2, s_max=600, qtokens=None, lengths=DECODE_LENGTHS):
    """K4's inputs: a (B, Hq, D) query, or (B, Hq, T, D) with ``qtokens``,
    over a cache of ``cache`` (token scales for the quantized kinds)."""
    b = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    qshape = (b, hkv * group, d) if qtokens is None else (b, hkv * group, qtokens, d)
    q = _randn(qshape, 4, torch.bfloat16, cuda)
    kf = _randn((b, hkv, s_max, d), 5, torch.float32, cuda)
    vf = _randn((b, hkv, s_max, d), 6, torch.float32, cuda)
    if cache in FLOAT_CACHES:
        return q, kf.to(FLOAT_CACHES[cache]), vf.to(FLOAT_CACHES[cache]), lens, None, None
    fn = {"int8": quant.dynamically_quantize_int8, "e4m3": quant.dynamically_quantize_fp8,
          "int4": quant.dynamically_quantize_int4}[cache]
    (kc, ks), (vc, vs) = fn(kf, reduction_dim=-1), fn(vf, reduction_dim=-1)
    return q, kc, vc, lens, ks, vs


#: The cache types K4 and K10 take (fault 12: int4 and e4m3; fault 13:
#: float16 and float32).
CACHE_KINDS = ["int8", "bf16", "int4", "e4m3", "f16", "f32"]


@pytest.mark.parametrize("cache", CACHE_KINDS)
@pytest.mark.parametrize("group,d", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, cache, group, d):
    q, kc, vc, lens, ks, vs = _decode_case(cuda, cache, group, d)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    assert decode_attention.launches == before + 1
    again = decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    plain = decode_attention_plain(q, kc, vc, lens, ks, vs)
    torch.cuda.synchronize()
    assert bool((out[0] == 0).all())
    assert torch.isfinite(out.float()).all()
    _assert_decode_close(out, plain, lens)
    assert torch.equal(out, again)  # the merge sums in a fixed order


@pytest.mark.parametrize("qtype", [torch.float32, torch.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("cache", ["int8", "int4"])
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_decode_kernels_take_float_queries(cuda, kernel, cache, qtype):
    """Fault 12: float32 and float16 queries enter K4 and K10 rounded to
    bf16 (the plain versions round them likewise); the output is bf16, as
    JAX returns."""
    if kernel == "k4":
        q, kc, vc, lens, ks, vs = _decode_case(cuda, cache, 4, 128)
        q = q.to(qtype)
        out = decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs)
        plain = decode_attention_plain(q, kc, vc, lens, ks, vs)
    else:
        from quantumattention_tpu_torch.ops.paged import (
            paged_decode_attention, paged_decode_attention_plain)

        q, k, v, lens, table, ks, vs = _paged_case(cuda, (5, 16, 4, 32, 7, 128), cache)
        q = q.to(qtype)
        out = paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs,
                                     pages_per_block=1)
        plain = paged_decode_attention_plain(q, k, v, lens, table, ks, vs)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _assert_decode_close(out, plain, lens)


def _paged_case(cuda, shape, kind, qtokens=None):
    """K10's inputs over a shuffled pool: ragged lengths with an empty and
    a full slot, table entries past each sequence's pages out of range;
    int8 and e4m3 pages with token scales, token-packed int4 pages (ps/2
    byte rows) with token scales, or bf16, fp16 or fp32 pages.  With
    ``qtokens`` a (B, Hq, T, D) query and every non-empty slot at least T
    long."""
    b, hq, hkv, ps, pps, d = shape
    pool = b * pps + 3
    g = torch.Generator().manual_seed(ps + d)
    table = torch.randperm(pool, generator=g)[: b * pps].reshape(b, pps).to(torch.int32)
    lens = torch.randint(qtokens or 1, pps * ps + 1, (b,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = 0, pps * ps
    pages_of = (lens + ps - 1) // ps
    table = torch.where(torch.arange(pps)[None] < pages_of[:, None], table, 99_999)
    kf = _randn((hkv, pool, ps, d), 1, torch.float32, cuda)
    vf = _randn((hkv, pool, ps, d), 2, torch.float32, cuda)
    if kind in FLOAT_CACHES:
        k, v, ks, vs = kf.to(FLOAT_CACHES[kind]), vf.to(FLOAT_CACHES[kind]), None, None
    elif kind == "int4":
        (k, ks), (v, vs) = (quant.quantize_int4_values(x, reduction_dim=-1) for x in (kf, vf))
        k, v = quant.pack_int4(k, axis=2), quant.pack_int4(v, axis=2)
    else:
        fn = quant.dynamically_quantize_int8 if kind == "int8" else quant.dynamically_quantize_fp8
        (k, ks), (v, vs) = fn(kf, reduction_dim=-1), fn(vf, reduction_dim=-1)
    q = _randn((b, hq, d) if qtokens is None else (b, hq, qtokens, d), 3, torch.bfloat16, cuda)
    return q, k, v, lens.to(cuda), table.to(cuda), ks, vs


def _core_calls(cuda, kernel, kind, window_left=None):
    """One K4 or K10 call of the decode-attention core: (call(), raw(acc,
    ml), lengths, plan, rows a slot); raw launches the same call through the
    library's entry point into the partial buffers it is given.  With
    ``window_left`` both calls take that window."""
    from quantumattention_tpu_torch.ops import _native, decode, paged

    lib, scale = _native.library(), 128 ** -0.5
    code = decode.KINDS["int4_pages" if kind == "int4" and kernel != "k4" else kind]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    wl = -1 if window_left is None else window_left
    if kernel == "k4":
        q, kc, vc, lens, ks, vs = _decode_case(cuda, kind, 4, 128)
        b, hq, hkv, smax = q.shape[0], q.shape[1], kc.shape[1], kc.shape[2]

        def call():
            return decode._decode_cuda(q, kc, vc, lens, ks, vs, scale, window_left)

        def raw(acc, ml):
            out = torch.empty_like(q)
            _native.check(lib.qa_decode(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ptr(ks), ptr(vs),
                                        lens.data_ptr(), out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
                                        b, hq, hkv, smax, 128, 1, code, wl,
                                        float(scale * decode.LOG2E), stream), "qa_decode")
    else:
        # k10: Llama-3-8B's heads; k10_g32: a GQA group of 32 (fault 11).
        shape = (16, 32, 8, 128, 8, 128) if kernel == "k10" else (6, 64, 2, 128, 8, 128)
        q, k, v, lens, table, ks, vs = _paged_case(cuda, shape, kind)
        ps = shape[3]
        b, hq, hkv, smax = q.shape[0], q.shape[1], k.shape[0], table.shape[1] * ps

        def call():
            return paged._paged_cuda(q, k, v, lens, table, ks, vs, scale, kind == "int4",
                                     window_left)

        def raw(acc, ml):
            out = torch.empty_like(q)
            _native.check(lib.qa_paged_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs), lens.data_ptr(),
                table.data_ptr(), out.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, hq, hkv,
                k.shape[1], ps, table.shape[1], 128, 1, code, wl, float(scale * decode.LOG2E),
                stream), "qa_paged_decode")
    plan = decode.card_plan(code, b, hq, hkv, 128, smax, 0 if kernel == "k4" else ps)
    return call, raw, lens, plan, smax


@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("kernel", ["k4", "k10", "k10_g32"])
def test_decode_core_split_is_the_schedule(cuda, kernel, kind):
    """The card's split is ops/decode.decode_schedule: the partials the
    kernel writes are exactly the (CTA, segment) runs of the Python
    schedule, K10's group of 32 split over segments as K4's is (its
    segments those of ``decode.core_segments``)."""
    from quantumattention_tpu_torch.ops import decode

    _, raw, lens, plan, smax = _core_calls(cuda, kernel, kind)
    acc, ml = decode.core_scratch(plan, lens.shape[0], cuda)
    ml.fill_(float("nan"))
    raw(acc, ml)
    torch.cuda.synchronize()
    written = set(torch.nonzero(torch.isfinite(ml[:, 0, 0])).flatten().tolist())
    hq, hkv = {"k4": (8, 2), "k10": (32, 8), "k10_g32": (64, 2)}[kernel]
    kcode = decode.KINDS["int4_pages" if kind == "int4" and kernel != "k4" else kind]
    assert plan["segments"] == decode.core_segments(hq, hkv, 128, kcode)
    sched = decode.decode_schedule(lens.cpu().numpy(), plan["segments"], decode.ROWS_PER_TILE,
                                   plan["ctas"], smax)
    assert written == {c + seg for c in range(sched.ctas) for seg, _, _ in sched.runs(c)}
    assert plan["ctas"] <= 256


@pytest.mark.parametrize("hq,hkv,d,kind,want", [
    (32, 8, 128, "int8", (1, 1, 4, 128)),     # Llama-3-8B
    (32, 32, 96, "bf16", (1, 1, 1, 96)),      # Phi-3-mini
    (16, 8, 256, "int8", (1, 1, 2, 256)),
    (8, 2, 512, "int8", (1, 2, 4, 256)),      # two column splits of 256
    (8, 2, 512, "bf16", (1, 8, 4, 64)),       # bf16: eight of 64
    (16, 1, 320, "bf16", (1, 5, 16, 64)),
    (32, 1, 128, "int8", (2, 1, 16, 128)),    # G = 32: two query splits
    (40, 2, 72, "int8", (2, 1, 16, 72)),      # G = 20: 16 + 4
    (32, 8, 128, "int4", (1, 1, 4, 128)),     # head-dim-packed int4: one frame of W
    (16, 8, 320, "int4", (1, 2, 2, 256)),     # at 512: the low and the high nibbles
    (32, 8, 128, "e4m3", (1, 1, 4, 128)),
    (8, 2, 512, "f16", (1, 8, 4, 64)),        # fp16 as bf16: eight of 64
    (32, 8, 128, "f32", (1, 1, 4, 128)),      # fp32 up to 128: one split
    (16, 8, 256, "f32", (1, 4, 2, 64)),       # fp32 above: 64 columns a split
    (8, 2, 512, "f32", (1, 8, 4, 64)),
])
def test_decode_core_plan(cuda, hq, hkv, d, kind, want):
    """The card's plan splits a (slot, KV head) into (query splits, column
    splits, rows of a split, columns of a split): up to 16 query heads a
    split and, at the instantiated width 512, 256 output columns (1-byte
    codes; head-dim-packed int4 its two nibble halves) or 64 (bf16), so
    that two stages of K and V tiles fit the shared memory; the segments
    are ``decode.core_segments``."""
    from quantumattention_tpu_torch.ops import decode

    plan = decode.card_plan(decode.KINDS[kind], 4, hq, hkv, d, 2048)
    assert (plan["qsplits"], plan["csplits"], plan["qrows"], plan["ccols"]) == want
    assert plan["segments"] == hkv * plan["qsplits"] * plan["csplits"]
    assert plan["segments"] == decode.core_segments(hq, hkv, d, decode.KINDS[kind])


@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("kernel", ["k4", "k10", "k10_g32"])
def test_decode_core_is_deterministic_and_capturable(cuda, kernel, kind):
    """Two runs give the same bits, and so does one call captured in a CUDA
    graph and replayed."""
    call, _, _, _, _ = _core_calls(cuda, kernel, kind)
    want = call()
    assert torch.equal(call(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: Verification lengths: every non-empty slot holds at least T = 5 rows
#: (a shorter one has candidates that see no row, which no kernel defines).
VERIFY_LENGTHS = [0, 5, 6, 63, 64, 65, 257, 600]


def _verify_call(cuda, kernel, kind, t, group):
    """(kernel call, plain call, lengths, verify-launch counter's owner) of
    one multi-query call of K4 or K10 with T = t candidates a head."""
    from quantumattention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)

    if kernel == "k4":
        q, kc, vc, lens, ks, vs = _decode_case(cuda, kind, group, 128, qtokens=t, lengths=VERIFY_LENGTHS)
        return (lambda: decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs),
                lambda: decode_attention_plain(q, kc, vc, lens, ks, vs), lens, decode_attention)
    q, k, v, lens, table, ks, vs = _paged_case(cuda, (6, 8 * group, 8, 128, 5, 128), kind, qtokens=t)
    return (lambda: paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs,
                                           pages_per_block=1),
            lambda: paged_decode_attention_plain(q, k, v, lens, table, ks, vs), lens,
            paged_decode_attention)


@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t", [2, 5])
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_verify_kernels_match_plain(cuda, kernel, t, group, kind):
    """K4 and K10 in multi-query mode (T candidates a head, the G * T query
    rows packed t-fastest and split in sixteens) against their plain
    versions within the decode bars, over every cache kind; an empty slot
    gives exact zeros; the call counts as a verify launch."""
    call, plain_call, lens, wrapper = _verify_call(cuda, kernel, kind, t, group)
    before = wrapper.verify_launches
    out = call()
    torch.cuda.synchronize()
    assert wrapper.verify_launches == before + 1
    plain = plain_call()
    assert out.shape == plain.shape and out.shape[2] == t
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    _assert_decode_close(out, plain, lens)


@pytest.mark.parametrize("kind", ["int8", "bf16", "int4", "f32"])
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_verify_kernels_replay_bitwise(cuda, kernel, kind):
    """One verify call (T = 5, G = 4: two query splits) captured in a CUDA
    graph: two replays give the eager call's bits."""
    call, _, _, _ = _verify_call(cuda, kernel, kind, 5, 4)
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _spec_model(dev):
    """A bf16 target of 2 layers at head dim 128 and a 1-layer draft of the
    same vocabulary, seeded."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                            num_q_heads=8, num_kv_heads=2, head_dim=128)
    dcfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=1,
                             num_q_heads=4, num_kv_heads=2, head_dim=64)
    return (llama.init_params(torch.Generator(dev).manual_seed(1), cfg, dev), cfg,
            llama.init_params(torch.Generator(dev).manual_seed(2), dcfg, dev), dcfg)


@pytest.mark.parametrize("draft", ["small", "self"])
@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_speculative_engine_on_card_emits_verify_argmax(cuda, backend, draft):
    """A greedy engine with a draft on the card: K4 or K10 verify in every
    round, and each round's emitted tokens are the argmax of its verify
    logits at their positions (up to and including the first mismatch).
    The target as its own draft has proposals accepted, so the backends
    roll back past accepted tokens; a paged engine returns every page."""
    from quantumattention_tpu_torch.ops.paged import paged_decode_attention

    params, cfg, dparams, dcfg = _spec_model(cuda)
    if draft == "self":
        dparams, dcfg = params, cfg
    kw = dict(cache_backend="paged", page_size=64) if backend == "paged" else {}
    eng = Engine(params, cfg, num_slots=2, max_len=256, draft=(dparams, dcfg), spec_tokens=4, **kw)
    reqs = [eng.submit([3, 5, 7, 11, 13], max_new_tokens=20), eng.submit(list(range(40)), max_new_tokens=17)]
    rounds, verify, round_fn = [], eng._backend.verify, eng._speculative_round

    def recorded_verify(*args):
        logits = verify(*args)
        rounds[-1]["argmax"] = logits.argmax(-1).cpu().numpy()
        return logits

    def recorded_round():
        before = {s: (r, len(r.output)) for s, r in eng.active.items()}
        rounds.append({})
        out = round_fn()
        rounds[-1]["emitted"] = {s: r.output[n0:] for s, (r, n0) in before.items()}
        return out

    eng._backend.verify, eng._speculative_round = recorded_verify, recorded_round
    wrapper = decode_attention if backend == "slots" else paged_decode_attention
    before = wrapper.verify_launches
    eng.run_to_completion()
    assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
    assert rounds and wrapper.verify_launches - before == cfg.num_layers * len(rounds)
    for rd in rounds:
        for slot, emitted in rd["emitted"].items():
            assert emitted and emitted == rd["argmax"][slot, : len(emitted)].tolist()
    if draft == "self":
        assert eng.stats["spec_accepted"] > 0
    if backend == "paged":
        assert int(eng.alloc.allocated.sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["f16", "f32"])
@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_float_caches_serve_on_card(cuda, backend, dtype):
    """Fault 13: an engine over a float16 or float32 cache serves two
    requests through K4 or K10 on the card (they raised before)."""
    params, cfg, _, _ = _spec_model(cuda)
    kw = dict(cache_backend="paged", page_size=64) if backend == "paged" else {}
    eng = Engine(params, cfg, num_slots=2, max_len=256, cache_dtype=dtype, **kw)
    reqs = [eng.submit([3, 5, 7], max_new_tokens=6), eng.submit(list(range(30)), max_new_tokens=4)]
    eng.run_to_completion()
    assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    q = _randn((1, 2, 8, 64), 7, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :44].contiguous(), q[..., :44].contiguous(), q[..., :44].contiguous())
    lens = torch.tensor([3], dtype=torch.int64, device=cuda)
    cache = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q[:, :, 0], cache, cache, lens)


def _params_on(params, dev):
    p = {k: v.to(dev) for k, v in params.items() if k != "layers"}
    p["layers"] = [{k: v.to(dev) for k, v in layer.items()} for layer in params["layers"]]
    return p


@pytest.mark.parametrize("impl", ["fp8", "bf16"])
def test_model_step_on_card_matches_cpu(cuda, impl):
    """Prefill and three decode steps of the tiny model through the slots
    backend, on the card (K1, K4) and on the CPU (plain versions): logits
    within 3% of their largest magnitude, as tests/test_torch_llama.py
    holds the port to the JAX package."""
    import functools

    from quantumattention_tpu_torch.serving.backends import SlotsBackend

    cfg = llama.tiny(attention_impl=impl)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    last = [127, 68]
    steps = rng.integers(0, cfg.vocab_size, (3, 2))
    logits = {}
    for dev in ("cpu", "cuda"):
        backend = SlotsBackend(cfg, num_slots=2, max_len=256, cache_dtype=torch.int8, device=dev)
        out = [backend.prefill_and_write(
            functools.partial(llama.forward_prefill, cfg=cfg), _params_on(params, dev),
            tokens.to(dev), last, [0, 1], [128, 69], 128,
        )]
        for cur in steps:
            out.append(backend.decode(_params_on(params, dev), cur, np.array([True, True])))
        logits[dev] = [t.cpu() for t in out]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert bool(torch.isfinite(b).all())
        assert float((a - b).abs().max()) <= 0.03 * float(a.abs().max())


def test_engine_on_card(cuda):
    """Serving on the card: every request completes through K1 and K4 and
    the first tokens equal the CPU engine's (later tokens of an untrained
    model may flip on near-ties, which the logits test above bounds)."""
    cfg = llama.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(1, 70))]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(_params_on(params, dev), cfg, num_slots=2, max_len=256, cache_dtype=torch.int8)
        k1, k4 = flash_attention.launches, decode_attention.launches
        reqs = [eng.submit(pr, max_new_tokens=6) for pr in prompts]
        eng.run_to_completion()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        if dev == "cuda":
            assert flash_attention.launches - k1 == cfg.num_layers * eng.stats["prefill_forwards"]
            assert decode_attention.launches - k4 == cfg.num_layers * eng.stats["decode_steps"]
        outs[dev] = [r.output[0] for r in reqs]
    assert outs["cpu"] == outs["cuda"]


def test_quantizers_match_on_card(cuda):
    x = _randn((2, 3, 50, 64), 8, torch.float32, cuda)
    for fn in (quant.quantize_head_wise, quant.quantize_token_wise):
        for qdt in (torch.float8_e4m3fn, torch.int8):
            gv, gs = fn(x, qdt)
            cv, cs = fn(x.cpu(), qdt)
            np.testing.assert_array_equal(gv.cpu().float().numpy(), cv.float().numpy())
            # amax / qmax may round one float32 ulp apart on the two devices.
            np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=2.4e-7, atol=0)


def _max_rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


BWD_SHAPES = [(2, 4, 4, 3, 3, 64, True)] + FLASH_SHAPES[1:] + [
    (1, 4, 2, 65, 65, 256, True), (2, 2, 2, 130, 100, 256, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_bwd_kernels_match_plain(cuda, shape, dtype):
    """K1's residuals, then K2 and K3, against their plain versions."""
    b, hq, hkv, sq, skv, d, causal = shape
    q = _randn((b, hq, sq, d), 11, dtype, cuda)
    k = _randn((b, hkv, skv, d), 12, dtype, cuda)
    v = _randn((b, hkv, skv, d), 13, dtype, cuda)
    do = _randn((b, hq, sq, d), 14, dtype, cuda)
    out, (m, l) = flash_attention(q, k, v, is_causal=causal, return_residuals=True)
    _, (pm, pl) = flash_attention_plain(q, k, v, is_causal=causal, return_residuals=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal)
    torch.cuda.synchronize()
    assert m.shape == l.shape == (b, hq, sq)
    tol = 1e-3 if dtype == torch.bfloat16 else 3e-2
    assert float((m - pm).abs().max()) <= tol
    assert float(((l - pl).abs() / pl).max()) <= tol
    for g, p, t in zip(grads, plain, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert bool(torch.isfinite(g).all())
        assert _max_rel(g, p) < GRAD_BAR


ANY_WIDTHS = [72, 96, 160, 320, 512]
K1_ANY_SHAPES = [  # (B, Hq, Hkv, Sq, Skv, q_offset)
    (2, 4, 1, 3, 3, 0),
    (1, 8, 2, 100, 357, 130),
    (1, 4, 4, 200, 200, 0),
]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", K1_WIDTH_MODES)
@pytest.mark.parametrize("shape", K1_ANY_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d", ANY_WIDTHS)
def test_flash_kernel_any_width(cuda, d, shape, mode, causal):
    """K1 at head dims between and above the instantiated widths (zero
    columns past D; 8-bit Q/K of D % 16 == 8, e4m3 at D = 72, zero-padded by
    the wrapper; two CTAs a Q block above 256) over its seven operand types,
    against its plain version and the fp32 oracle, residuals included."""
    _k1_width_case(cuda, d, shape, mode, causal)


BWD_ANY_SHAPES = [(3, 3), (100, 77), (130, 130)]  # (Sq, Skv)


@pytest.mark.parametrize("sqkv", BWD_ANY_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 96, 128, 256, 320, 512])
def test_flash_bwd_any_width(cuda, d, causal, group, sqkv):
    """K2 and K3 against their plain versions and the fp32 oracle's
    autograd over head dims, GQA groups (K3's cluster sum of 1, 4 and 8
    CTAs) and ragged lengths."""
    sq, skv = sqkv
    hkv = 2
    q = _randn((1, hkv * group, sq, d), 41, torch.bfloat16, cuda)
    k = _randn((1, hkv, skv, d), 42, torch.bfloat16, cuda)
    v = _randn((1, hkv, skv, d), 43, torch.bfloat16, cuda)
    do = _randn((1, hkv * group, sq, d), 44, torch.bfloat16, cuda)
    out, (m, l) = flash_attention(q, k, v, is_causal=causal, return_residuals=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = sdpa_reference(*leaves, is_causal=causal, out_dtype=torch.float32)
    oracle = torch.autograd.grad(ref, leaves, do.float())
    torch.cuda.synchronize()
    for g, p, o, t in zip(grads, plain, oracle, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert bool(torch.isfinite(g).all())
        assert _max_rel(g, p) < GRAD_BAR
        assert _max_rel(g, o) < GRAD_BAR


@pytest.mark.parametrize("d,group,causal", [(128, 4, True), (96, 8, False), (512, 4, True),
                                            (64, 16, True), (128, 12, False)])
def test_flash_bwd_is_deterministic(cuda, d, group, causal):
    """Two runs of K2 and K3 give the same bits: K3 sums the GQA group in a
    fixed order (a cluster of up to 8 CTAs, and a loop over q heads inside
    each CTA past 8), no float atomics anywhere."""
    q = _randn((2, 2 * group, 150, d), 51, torch.bfloat16, cuda)
    k = _randn((2, 2, 150, d), 52, torch.bfloat16, cuda)
    v = _randn((2, 2, 150, d), 53, torch.bfloat16, cuda)
    do = _randn((2, 2 * group, 150, d), 54, torch.bfloat16, cuda)
    out, (m, l) = flash_attention(q, k, v, is_causal=causal, return_residuals=True)
    first = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    second = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal)
    torch.cuda.synchronize()
    for a, b, p in zip(first, second, plain):
        assert torch.equal(a, b)
        assert _max_rel(a, p) < GRAD_BAR


@pytest.mark.parametrize("entry", ["attn_func", "fp8_attn_func", "fp8_token_wise_attn_func"])
def test_entry_points_differentiable_on_card(cuda, entry):
    """Gradients reach q, k and v through the kernels on CUDA tensors, and
    equal the CPU's (plain versions) within the gradient bar."""
    fn = getattr(qt, entry)
    grads = {}
    for dev in ("cpu", "cuda"):
        qkv = [_randn((1, h, 200, 128), 20 + i, torch.bfloat16, "cpu").to(dev).requires_grad_()
               for i, h in enumerate((8, 2, 2))]
        out = fn(*qkv, is_causal=True)
        assert out.grad_fn is not None
        grads[dev] = torch.autograd.grad((out.float() ** 2).sum(), qkv)
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert bool(torch.isfinite(g).all()) and float(g.float().abs().max()) > 0
        assert _max_rel(g.cpu(), c) < GRAD_BAR


@pytest.mark.parametrize("impl", ["fp8", "bf16"])
def test_train_step_on_card_matches_cpu(cuda, impl):
    """Loss and gradients of the tiny model on the card (K1, K2, K3) and on
    the CPU, then one SGD step on the card; tests/test_torch_train.py holds
    the CPU path to the JAX package with the same bounds."""
    cfg = llama.tiny(attention_impl=impl)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65)))
    out = {}
    for dev in ("cpu", "cuda"):
        counts = (flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
        out[dev] = llama.loss_and_grads(_params_on(params, dev), tokens.to(dev), cfg)
        if dev == "cuda":
            ran = (flash_attention.launches - counts[0], flash_bwd_dq.launches - counts[1],
                   flash_bwd_dkv.launches - counts[2])
            assert ran == (2 * cfg.num_layers if impl == "fp8" else cfg.num_layers,
                           cfg.num_layers, cfg.num_layers)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-2 * abs(float(lc))
    for a, b in zip(llama.leaves(gg), llama.leaves(gc)):
        rel = torch.linalg.vector_norm(a.cpu().float() - b.float()) / torch.linalg.vector_norm(b.float())
        assert float(rel) < 5e-2
    new, loss = llama.train_step(_params_on(params, "cuda"), tokens.cuda(), cfg)
    assert abs(float(loss) - float(lg)) <= 1e-3 * abs(float(lg))
    assert all(bool(torch.isfinite(p.float()).all()) for p in llama.leaves(new))


# ---------------------------------------------------------------------------
# K5/K6/K7 (quantized products) and K8 (fused layer tail).  Kernel and
# plain version both sum in fp32 and round once to bf16 (K8 at the same
# bf16 rounding points); they sum in other orders, so outputs may differ by
# a couple of bf16 ulps: max|a - b| <= 2^-6 max|b| (2 to 4 ulps at the
# largest magnitude).
# ---------------------------------------------------------------------------

QREL = 2.0 ** -6
QMM_SHAPES = [(1, 256, 128), (4, 512, 384), (16, 1024, 256), (33, 256, 384),
              (100, 512, 1024), (4, 4096, 4096)]


def _qmat(k, n, seed, int4, device):
    from quantumattention_tpu_torch.models import quantized

    w = _randn((k, n), seed, torch.float32, device) / k ** 0.5
    return quantized.quantize_matrix_int4(w) if int4 else quantized.quantize_matrix(w)


def _close_rel(a, b, bound=QREL):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert bool(torch.isfinite(a).all())
    assert float((a.float() - b.float()).abs().max()) <= bound * float(b.float().abs().max())


#: K5/K7 at the rows around the kernel's widths (8 .. 128 stream-K, whole
#: 128-row tiles above), over one k-block and one column tile, then over
#: shapes of several tiles (N % 256 == 128 among them).
QMM_ROWS = [1, 4, 9, 16, 17, 64, 65, 256, 257, 1536]
QMM_CASES = [(m, k, 128, int4, splits) for m in QMM_ROWS for int4, k in ((False, 128), (True, 256))
             for splits in ([None] if int4 else [None, 1, 3])]
QMM_CASES += [(m, k, n, int4, splits) for m, k, n in QMM_SHAPES for int4 in (False, True)
              for splits in ([None] if int4 else [None, 1, 3])]


def _qmm_ids(case):
    m, k, n, int4, splits = case
    return f"{m}x{k}x{n}-{'int4' if int4 else 'int8'}-{'auto' if splits is None else f's{splits}'}"


def _graph_call(fn):
    """One call of ``fn`` captured in a CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    graph.replay()
    torch.cuda.synchronize()
    return got


@pytest.mark.parametrize("case", QMM_CASES, ids=_qmm_ids)
def test_qmm_kernels_match_plain(cuda, case):
    """K5/K6/K7 against their plain versions (K6: ``n_streams`` K ranges
    summed in order, at the K5-K9 bar); every bf16 call on the register-A
    wgmma kernel, counted as K6 where the split rule or ``n_streams`` > 1
    says so; two runs and a graph-captured replay bitwise equal (the
    stream-K split is reduced in CTA order)."""
    from quantumattention_tpu_torch.ops import qmm

    m, k, n, int4, splits = case
    x = _randn((m, k), 30, torch.bfloat16, cuda)
    w = _qmat(k, n, 31, int4, cuda)
    counts = (qmm.quantized_matmul.launches, qmm.quantized_matmul.splitk_launches,
              qmm.quantized_matmul4.launches)
    routes = dict(qmm.route_launches)
    if int4:
        call = lambda: qmm.quantized_matmul4(x, w["q4"], w["s"])  # noqa: E731
        plain = qmm.quantized_matmul4_plain(x, w["q4"], w["s"])
    else:
        call = lambda: qmm.quantized_matmul(x, w["q"], w["s"], n_streams=splits)  # noqa: E731
        plain = qmm.quantized_matmul_plain(x, w["q"], w["s"], splits or 1)
    out = call()
    torch.cuda.synchronize()
    _close_rel(out, plain)
    ran = (qmm.quantized_matmul.launches - counts[0], qmm.quantized_matmul.splitk_launches - counts[1],
           qmm.quantized_matmul4.launches - counts[2])
    assert sum(ran) == 1 and (ran[2] == 1) == int4
    if not int4:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert ran[1] == int(qmm.is_split_k(m, n, splits, sms))
    assert {r: qmm.route_launches[r] - routes[r] for r in routes} == {
        r: int(r == "wgmma") for r in routes}
    assert torch.equal(call(), out)
    assert torch.equal(_graph_call(call), out)
    assert torch.equal(_graph_call(call), out)


@pytest.mark.parametrize("mkn", [(m, k, n) for m in QMM_ROWS for k, n in ((128, 128), (512, 384), (4096, 28672), (14336, 4096))],
                         ids=lambda s: "x".join(map(str, s)))
def test_qgemm_schedule_on_card_is_the_python_one(cuda, mkn):
    """The schedule and column permutation the K5/K7 kernel computes on the
    card (csrc/qgemm.cu) are ops/qmm's Python twins."""
    from quantumattention_tpu_torch.ops import qmm

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qmm.card_qgemm_schedule(*mkn) == qmm.qgemm_schedule(*mkn, sms)
    assert qmm.card_qgemm_columns() == [qmm.qgemm_column(i // 64, i % 64) for i in range(128)]


@pytest.mark.parametrize("kernel", ["k5", "k6", "k7"])
@pytest.mark.parametrize("m", [1, 4, 37, 300])
def test_qmm_float32_rows_match_plain(cuda, kernel, m):
    """Fault 10: float32 activations through K5, K6 and K7 on the card
    return float32 within 1e-5 of max|plain| (the CPU suite's fp32 bar,
    tests/test_torch_qmm.py), as JAX's kernels take and return them."""
    from quantumattention_tpu_torch.ops import qmm

    k, n = 1024, 384
    x = _randn((m, k), 34, torch.float32, cuda)
    w = _qmat(k, n, 35, kernel == "k7", cuda)
    before = qmm.route_launches["f32"]
    if kernel == "k7":
        out, plain = qmm.quantized_matmul4(x, w["q4"], w["s"]), qmm.quantized_matmul4_plain(x, w["q4"], w["s"])
    else:
        streams = 3 if kernel == "k6" else 1
        out = qmm.quantized_matmul(x, w["q"], w["s"], n_streams=streams)
        plain = qmm.quantized_matmul_plain(x, w["q"], w["s"], streams)
    torch.cuda.synchronize()
    assert qmm.route_launches["f32"] == before + 1
    _close_rel(out, plain, 1e-5)


def test_qmm_wrappers_refuse_what_they_do_not_take(cuda):
    from quantumattention_tpu_torch.ops import qmlp, qmm

    w = _qmat(256, 128, 32, False, cuda)
    x32 = _randn((4, 256), 33, torch.float32, cuda)
    # float32 rows are K5's (fault 10), not the tail product's.
    _close_rel(qmm.quantized_matmul(x32, w["q"], w["s"]), qmm.quantized_matmul_plain(x32, w["q"], w["s"]), 1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        qmlp.tail_matmul(x32, w)
    with pytest.raises(ValueError, match="float16"):
        qmm.quantized_matmul(x32.half(), w["q"], w["s"])
    w100 = _qmat(256, 100, 32, False, cuda)
    with pytest.raises(ValueError, match="N % 128"):
        qmm.quantized_matmul(_randn((4, 256), 33, torch.bfloat16, cuda), w100["q"], w100["s"])
    x = _randn((4, 512), 33, torch.bfloat16, cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        qmm.quantized_matmul(x, w["q"], w["s"])


#: (M, E, I, Q, F): the row counts around the tail product's widths (8,
#: 16, 32, 64, 128, 256), and widths that give CTAs several tiles.
TAIL_SHAPES = [(1, 256, 512, 256, 384), (4, 256, 512, 256, 384), (9, 256, 512, 512, 512),
               (16, 512, 768, 256, 384), (17, 256, 512, 512, 512), (64, 512, 1024, 512, 768),
               (65, 256, 512, 256, 384), (256, 512, 1024, 512, 768)]


@pytest.mark.parametrize("fold", [False, True], ids=["tail", "fold"])
@pytest.mark.parametrize("fmt", ["int8", "int4", "mixed", "no-wo"])
@pytest.mark.parametrize("shape", TAIL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_layer_tail_kernel_matches_plain(cuda, shape, fmt, fold):
    from quantumattention_tpu_torch.ops import qmlp

    m, e, inter, q_dim, f = shape
    int4 = fmt in ("int4", "mixed")
    wo = None if fmt == "no-wo" else _qmat(q_dim, e, 40, fmt == "int4", cuda)
    gate, up = _qmat(e, inter, 41, int4, cuda), _qmat(e, inter, 42, int4, cuda)
    key = "q4" if int4 else "q"
    w_gu = {key: torch.cat([gate[key], up[key]], -1), "s": torch.cat([gate["s"], up["s"]], -1)}
    w_down = _qmat(inter, e, 43, int4, cuda)
    norm = _randn((e,), 44, torch.float32, cuda).abs() + 0.5
    x = _randn((m, e), 45, torch.bfloat16, cuda)
    kw = dict(eps=1e-5)
    if wo is not None:
        kw.update(attn_out=_randn((m, q_dim), 46, torch.bfloat16, cuda), wo=wo)
    if fold:
        kw.update(next_attn_norm=norm.flip(0).contiguous(), next_w_qkv=_qmat(e, f, 47, int4, cuda))
    before = qmlp.fused_layer_tail.launches
    got = qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)
    want = qmlp.fused_layer_tail_plain(x, norm, w_gu, w_down, **kw)
    again = qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)
    torch.cuda.synchronize()
    assert qmlp.fused_layer_tail.launches == before + 2
    assert qmlp.fused_layer_tail.last_kernels == 5 + (wo is not None) + 2 * fold
    for a, b, c in zip(*((t if fold else [t]) for t in (got, want, again))):
        _close_rel(a, b)
        assert torch.equal(a, c)  # bitwise repeatable: a fixed reduction order


TAIL_PRODUCT_SHAPES = [(512, 384), (4096, 1024), (1024, 4096)]  # (K, N)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("kn", TAIL_PRODUCT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 64, 65, 128, 256])
def test_tail_product_matches_plain(cuda, m, kn, int4):
    """The tail product alone (csrc/tail.cu) against its plain version at
    every activation width, over shapes whose CTAs hold one unit, several
    units of one tile, or units of two tiles; two runs agree bitwise, and
    the card's schedule is the Python one."""
    from quantumattention_tpu_torch.ops import qmlp

    k, n = kn
    x = _randn((m, k), 60, torch.bfloat16, cuda)
    w = _qmat(k, n, 61, int4, cuda)
    before = qmlp.tail_matmul.launches
    got = qmlp.tail_matmul(x, w)
    again = qmlp.tail_matmul(x, w)
    torch.cuda.synchronize()
    assert qmlp.tail_matmul.launches == before + 2
    _close_rel(got, qmlp.tail_matmul_plain(x, w))
    assert torch.equal(got, again)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qmlp.card_tail_schedule(m, n, k) == qmlp.tail_schedule(m, n, k, sms)


def _quant_tiny():
    return llama.tiny(hidden_size=256, intermediate_size=512, num_q_heads=4, num_kv_heads=2,
                      head_dim=64)


#: Engine prefill logits, card (K1 fp8, K5-K8) against the CPU engine
#: running the same fused path through the plain versions: ||a - b|| / ||b||
#: per request.  The rounding points agree; e4m3 attention and bf16 sums
#: taken in other orders do not (chip_smoke.py's PREFILL_REL_BOUND).
ENGINE_LOGIT_REL = 0.1


def _record_prefills(eng):
    """Collect the engine's prefill logits, one (B, vocab) tensor a forward."""
    backend, seen = eng._backend, []
    orig = backend.prefill_and_write

    def recording(*args):
        logits = orig(*args)
        seen.append(logits.float().cpu())
        return logits

    backend.prefill_and_write = recording
    return seen


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_quantized_engine_on_card(cuda, int4):
    """A fused quantized tree serves on the card through K5 (or K7), K8 on
    every decode layer tail, K1 and K4.  Its prefill logits agree with the
    CPU engine's (the same fused path, forced through the plain versions),
    and so do its first tokens wherever the CPU's top two logits are more
    than twice the logits' difference apart (an untrained model has
    near-ties that either side may break)."""
    from quantumattention_tpu_torch.models import quantized
    from quantumattention_tpu_torch.ops import qmlp, qmm

    cfg = _quant_tiny()
    quant = quantized.quantize_params_int4 if int4 else quantized.quantize_params
    params = quantized.fuse_projections(quant(llama.init_params(torch.Generator().manual_seed(0), cfg)))
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(1, 70))]
    outs, logits = {}, {}
    for dev in ("cpu", "cuda"):
        flags = {"kernel.qmm": "force", "kernel.qmlp": "force"} if dev == "cpu" else {}
        with qt.config.patch(flags):
            eng = Engine(_tree_on(params, dev), cfg, num_slots=2, max_len=256, cache_dtype=torch.int8)
            logits[dev] = _record_prefills(eng)
            k8 = qmlp.fused_layer_tail.launches
            k567 = (qmm.quantized_matmul.launches + qmm.quantized_matmul.splitk_launches,
                    qmm.quantized_matmul4.launches)
            reqs = [eng.submit(pr, max_new_tokens=6) for pr in prompts]
            eng.run_to_completion()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        if dev == "cuda":
            assert qmlp.fused_layer_tail.launches - k8 >= cfg.num_layers * eng.stats["decode_steps"]
            # The int8 LM head runs K5/K6 in both trees; int4 projections K7.
            assert qmm.quantized_matmul.launches + qmm.quantized_matmul.splitk_launches > k567[0]
            assert (qmm.quantized_matmul4.launches > k567[1]) == int4
        outs[dev] = [r.output[0] for r in reqs]
    firsts = []
    for a, b in zip(logits["cuda"], logits["cpu"]):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max()) < ENGINE_LOGIT_REL
        top2 = b.topk(2, dim=-1).values
        firsts += (top2[:, 0] - top2[:, 1] > 2 * (a - b).abs().amax(dim=-1)).tolist()
    # Prefill groups run in submission order here (two slots, FIFO).
    for clear, x, y in zip(firsts, outs["cuda"], outs["cpu"]):
        assert x == y or not clear


def _tree_on(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_on(v, dev) for v in tree]
    return tree.to(dev)


#: K9 against its plain version: both round P, the head output and the
#: tail at the same points and sum in fp32 in other orders; max|a - b| /
#: max|b| within 2^-6, chip_smoke.py's QUANT_KERNEL_REL.
K9_REL = 2.0 ** -6


def _qmat8(k, n, seed, dev):
    from quantumattention_tpu_torch.models import quantized

    return quantized.quantize_matrix(_randn((k, n), seed, torch.float32, dev) / np.sqrt(k))


@pytest.mark.parametrize("window", [None, 40], ids=["full", "window40"])
@pytest.mark.parametrize("b,s_max,group", [(1, 64, 2), (16, 128, 4), (32, 200, 1), (20, 64, 8),
                                           (64, 256, 2), (65, 96, 8)])
def test_fused_decode_layer_matches_plain(cuda, b, s_max, group, window):
    """K9 (attention, one CTA per KV head and slot, then K8's stages on the
    tail product) on ragged lengths with empty slots, slot counts of 1 and
    not a multiple of 16, a max_len that is not a multiple of 64, query
    groups of 1/2/4/8 and a window; a second run agrees bitwise."""
    from quantumattention_tpu_torch.ops import megastep

    e, inter, hkv, d = 256, 384, 2, 128
    hq = hkv * group
    layer = {"wo": _qmat8(hq * d, e, 40, cuda), "mlp_norm": _randn((e,), 41, torch.float32, cuda).abs() + 0.5,
             "w_gate_up": _qmat8(e, 2 * inter, 42, cuda), "w_down": _qmat8(inter, e, 43, cuda)}
    nxt = {"attn_norm": _randn((e,), 44, torch.float32, cuda).abs() + 0.5,
           "w_qkv": _qmat8(e, (hq + 2 * hkv) * d, 45, cuda)}
    kc, ks = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), 46, torch.float32, cuda), reduction_dim=-1)
    vc, vs = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), 47, torch.float32, cuda), reduction_dim=-1)
    lens = np.random.default_rng(b).integers(0, s_max + 1, b)
    lens[:3] = [0, 1, s_max] if b >= 3 else [s_max]
    ctx = {"lengths": torch.tensor(lens, dtype=torch.int32, device=cuda), "s_max": s_max,
           "window_left": None if window is None else window - 1}
    x = _randn((b, e), 48, torch.bfloat16, cuda)
    q = _randn((b, hq, d), 49, torch.bfloat16, cuda)
    for kw in ({}, {"next_attn_norm": nxt["attn_norm"], "next_w_qkv": nxt["w_qkv"]}):
        before = megastep.fused_decode_layer.launches
        got = megastep.fused_decode_layer(x, q, kc, vc, ks, vs, ctx, layer, eps=1e-5, **kw)
        ref = megastep.fused_decode_layer_plain(x, q, kc, vc, ks, vs, ctx, layer, eps=1e-5, **kw)
        again = megastep.fused_decode_layer(x, q, kc, vc, ks, vs, ctx, layer, eps=1e-5, **kw)
        torch.cuda.synchronize()
        assert megastep.fused_decode_layer.launches == before + 2
        ref = ref if kw else (ref, None)
        for a, r, a2 in zip(got, ref, again):
            if r is None:
                assert a is None
                continue
            assert bool(torch.isfinite(a.float()).all())
            assert float((a.float() - r.float()).abs().max() / r.float().abs().max()) <= K9_REL
            assert torch.equal(a, a2)


def test_fused_decode_layer_refuses_on_card(cuda):
    from quantumattention_tpu_torch.ops import megastep

    e, hkv, d, b = 256, 1, 128, 16
    layer = {"wo": _qmat8(16 * d, e, 50, cuda), "mlp_norm": torch.ones(e, device=cuda),
             "w_gate_up": _qmat8(e, 256, 51, cuda), "w_down": _qmat8(128, e, 52, cuda)}
    cache = torch.zeros((b, hkv, 64, d), dtype=torch.int8, device=cuda)
    sc = torch.ones((b, hkv, 64), device=cuda)
    ctx = {"lengths": torch.ones(b, dtype=torch.int32, device=cuda), "s_max": 64, "window_left": None}
    q = torch.zeros((b, 16, d), dtype=torch.bfloat16, device=cuda)  # a group of 16
    with pytest.raises(ValueError, match="query heads"):
        megastep.fused_decode_layer(torch.zeros((b, e), dtype=torch.bfloat16, device=cuda), q,
                                    cache, cache, sc, sc, ctx, layer, eps=1e-5)
    layer["wo"] = _qmat8(2 * d, e, 53, cuda)
    q = q[:, :2].contiguous()
    bad = {**ctx, "lengths": ctx["lengths"].long()}
    with pytest.raises(ValueError, match="lengths"):
        megastep.fused_decode_layer(torch.zeros((b, e), dtype=torch.bfloat16, device=cuda), q,
                                    cache, cache, sc, sc, bad, layer, eps=1e-5)


def _burst_model(dev):
    from quantumattention_tpu_torch.models import quantized

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                            num_q_heads=8, num_kv_heads=2, head_dim=128)
    tree = quantized.fuse_projections(
        quantized.init_quantized_params(torch.Generator().manual_seed(1), cfg))
    return cfg, _tree_on(tree, dev)


def _filled_backend(cfg, dev, lengths):
    from quantumattention_tpu_torch.serving.backends import SlotsBackend

    be = SlotsBackend(cfg, num_slots=16, max_len=64, device=dev)
    rng = np.random.default_rng(0)
    for c in be.caches:
        c.k.copy_(torch.from_numpy(rng.integers(-127, 128, tuple(c.k.shape)).astype(np.int8)))
        c.v.copy_(torch.from_numpy(rng.integers(-127, 128, tuple(c.v.shape)).astype(np.int8)))
        c.k_scale.fill_(0.01)
        c.v_scale.fill_(0.01)
        c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return be


def _uncaptured_steps(be, params, toks, n):
    """n greedy steps of the backend's own ``_step``, never captured (the
    paged tables loaded once; the step advances the device positions),
    every slot active; each step's tokens as host arrays."""
    if hasattr(be, "_load_tables"):
        be._load_tables()
    cur = torch.as_tensor(np.asarray(toks), dtype=torch.int64, device=be.device)
    active = torch.ones(be.num_slots, dtype=torch.bool, device=be.device)
    steps = []
    with torch.no_grad():
        for _ in range(n):
            cur = be._step(params, cur, active).argmax(-1)
            steps.append(cur.cpu().numpy())
    return steps


@pytest.mark.parametrize("megastep_flag", [True, False], ids=["k9", "lean_k8"])
def test_graph_burst_equals_eager_steps(cuda, megastep_flag):
    """A burst captured as a CUDA graph (one eager step, then replays of the
    captured step; a second burst replays only) gives the tokens of the
    uncaptured step run from the same state: the kernels are
    deterministic.  Each replay credits the kernels it launches."""
    from quantumattention_tpu_torch.ops import megastep, qmlp
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    cfg, params = _burst_model(cuda)
    lengths = [3, 0, 17, 40] + [9] * 12
    toks = np.arange(16) * 5 % cfg.vocab_size
    ones = np.ones(16, bool)
    with qt.config.patch({"kernel.megastep": megastep_flag}):
        be = _filled_backend(cfg, cuda, lengths)
        assert be.route(params) == ("mega" if megastep_flag else "unfused")
        counter = megastep.fused_decode_layer if megastep_flag else qmlp.fused_layer_tail
        before = counter.launches
        a = be.burst(params, toks, ones, np.full(16, 20, np.int32), np.full(16, -1, np.int32),
                     None, 6, SamplingParams(), False)
        b = be.burst(params, a[0][-1], ones, np.full(16, 20, np.int32), np.full(16, -1, np.int32),
                     None, 4, SamplingParams(), False)
        assert counter.launches - before == cfg.num_layers * 10
        assert be.stats == {"bursts": 2, "graph_captures": 1, "graph_replays": 9,
                            "step_captures": 0, "step_replays": 0}
        ref = _filled_backend(cfg, cuda, lengths)
        steps = _uncaptured_steps(ref, params, toks, 10)
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]]), np.stack(steps))
    for x, y in zip(be.caches, ref.caches):
        assert torch.equal(x.lengths, y.lengths) and torch.equal(x.k, y.k)


def test_sampled_graph_burst_on_card(cuda):
    """A sampled burst registers the engine's generator with the graph; the
    engine serves through it with finite logprobs."""
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    cfg, params = _burst_model(cuda)
    eng = Engine(params, cfg, num_slots=16, max_len=64, seed=3)
    sp = SamplingParams(temperature=0.8, top_k=20)
    reqs = [eng.submit([1, 2, 3], max_new_tokens=9, sampling=sp, logprobs=True) for _ in range(3)]
    eng.run_to_completion(decode_burst=8)
    assert eng._backend.stats["graph_captures"] == 1 and eng._backend.stats["graph_replays"] > 0
    for r in reqs:
        assert len(r.output) == len(r.logprob_output) == 9
        assert all(np.isfinite(v) and v <= 1e-6 for v in r.logprob_output)


def test_burst_spans_on_card(cuda, tmp_path):
    """Under the profiler, a burst on the card writes its graph's capture,
    its replays (one range a burst) and its fetch inside ``engine.burst``;
    the single step's graph writes its capture inside ``engine.decode``;
    the kernels share the ranges' clock."""
    import json

    cfg, params = _burst_model(cuda)
    eng = Engine(params, cfg, num_slots=16, max_len=64)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        reqs = [eng.submit([1, 2, 3], max_new_tokens=9) for _ in range(3)]
        eng.run_to_completion(decode_burst=4)
    assert all(r.done and len(r.output) == 9 for r in reqs)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(("engine.", "backend."))]
    names = [s[2] for s in spans]
    bursts = [s for s in spans if s[2] == "engine.burst"]
    steps = [s for s in spans if s[2] == "engine.decode"]
    bstats = eng._backend.stats
    assert bstats["graph_captures"] == bstats["step_captures"] == 1
    assert names.count("backend.capture") == bstats["graph_captures"] + bstats["step_captures"]
    assert names.count("backend.replay") == names.count("backend.fetch") == len(bursts)
    assert len(bursts) == bstats["bursts"] >= 2
    in_steps = 0
    for t0, t1, name in spans:
        if name.startswith("backend."):
            in_step = any(b0 <= t0 and t1 <= b1 for b0, b1, _ in steps)
            in_steps += in_step
            assert any(b0 <= t0 and t1 <= b1 for b0, b1, _ in bursts) or (
                in_step and name == "backend.capture"), name
    assert in_steps == bstats["step_captures"]
    kernels = [float(e["ts"]) for e in events if e.get("cat") == "kernel"]
    assert kernels and min(kernels) >= min(s[0] for s in spans) - 1e6


def test_engine_burst_on_card_matches_cpu(cuda):
    """The engine with bursts on the card (K9, graphs) against the CPU
    engine (K9's plain version, loops): first tokens equal; counters equal."""
    cfg, params = _burst_model("cpu")
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(1, 40))]
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        flags = {"kernel.megastep": "force", "kernel.qmlp": "force", "kernel.qmm": "force"} if dev == "cpu" else {}
        with qt.config.patch(flags):
            eng = Engine(_tree_on(params, dev), cfg, num_slots=16, max_len=64)
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_to_completion(decode_burst=4)
        assert all(r.done and len(r.output) == 8 for r in reqs)
        outs[dev], stats[dev] = [r.output[0] for r in reqs], dict(eng.stats)
    assert outs["cpu"] == outs["cuda"] and stats["cpu"] == stats["cuda"]


PAGED_SHAPES = [  # (B, Hq, Hkv, page_size, pages_per_seq, D)
    (16, 32, 8, 128, 8, 128),
    (5, 8, 8, 16, 9, 64),
    (3, 16, 1, 256, 3, 128),
    (7, 8, 2, 48, 5, 64),
    (4, 16, 8, 64, 6, 256),
    (6, 32, 32, 128, 4, 96),
    (5, 16, 4, 32, 7, 96),
    (4, 8, 2, 64, 5, 320),
    (3, 8, 8, 16, 6, 72),
    (3, 4, 1, 128, 3, 512),
    (4, 64, 2, 128, 4, 128),   # a GQA group of 32 (fault 11)
    (5, 32, 8, 8, 40, 128),    # pages of 8 tokens: rows by cp.async
    (3, 32, 8, 512, 2, 128),   # pages of 512: 32 boxes a page
    (4, 8, 2, 24, 9, 64),      # pages of 24 (int4: halves of 12)
]


@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_paged_kernel_matches_plain(cuda, shape, kind):
    """K10 against its plain version over a shuffled pool: ragged lengths
    with an empty and a full slot, table entries past each sequence's pages
    out of range (never read); every page type, GQA groups up to 32 and
    page sizes from 8 to 512."""
    from quantumattention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)

    q, k, v, lens, table, ks, vs = _paged_case(cuda, shape, kind)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs,
                                 pages_per_block=1)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_plain(q, k, v, lens, table, ks, vs)
    assert torch.isfinite(out.float()).all()
    _assert_decode_close(out, ref, lens)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_paged_kernel_refuses_on_card(cuda):
    from quantumattention_tpu_torch.ops.paged import paged_decode_attention

    # Pages of 24 tokens and float32 queries are taken now (faults 11, 12):
    # only what the kernel does not take is refused.
    q = torch.zeros((1, 4, 128), dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros((2, 8, 32, 128), dtype=torch.bfloat16, device=cuda)
    lens = torch.tensor([5], dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kp, kp, lens.long(), table)
    with pytest.raises(ValueError, match="float queries"):
        paged_decode_attention(q.to(torch.int8), kp, kp, lens, table)
    # fp16 pages are taken now (fault 13); float64 ones are not.
    assert paged_decode_attention(q, kp.half(), kp.half(), lens, table).shape == q.shape
    with pytest.raises(ValueError, match="take int8, e4m3, int4, bf16, float16 or float32"):
        paged_decode_attention(q, kp.double(), kp.double(), lens, table)


@pytest.mark.parametrize("sq,skv,off,d", [(256, 640, 384, 128), (100, 357, 257, 64),
                                          (64, 1024, 960, 128), (1, 130, 129, 64)])
@pytest.mark.parametrize("mode", ["bf16", "e4m3-head"])
def test_flash_q_offset_kernel_matches_plain(cuda, sq, skv, off, d, mode):
    """K1 with a position offset (chunked prefill) against its plain version
    and the fp32 oracle on the same inputs."""
    q = _randn((1, 8, sq, d), 4, torch.bfloat16, cuda)
    k = _randn((1, 2, skv, d), 5, torch.bfloat16, cuda)
    v = _randn((1, 2, skv, d), 6, torch.bfloat16, cuda)
    args, scales = (q, k, v), {}
    if mode != "bf16":
        q8, sq_ = quant.quantize_head_wise(q, torch.float8_e4m3fn)
        k8, sk = quant.quantize_head_wise(k, torch.float8_e4m3fn)
        args, scales = (q8, k8, v), {"scale_q": sq_, "scale_k": sk}
    out = flash_attention(*args, is_causal=True, q_offset=off, **scales)
    ref = flash_attention_plain(*args, is_causal=True, q_offset=off, **scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert float((out.float() - ref.float()).abs().max()) <= ATOL
    assert float((out.float() - ref.float()).pow(2).mean().sqrt()) < RMSE_BAR


def _filled_paged_backend(cfg, dev, lengths):
    from quantumattention_tpu_torch.serving.backends import PagedBackend

    be = PagedBackend(cfg, num_slots=16, max_len=128, page_size=32, device=dev)
    rng = np.random.default_rng(0)
    for lp in be.pages:
        lp.k.copy_(torch.from_numpy(rng.integers(-127, 128, tuple(lp.k.shape)).astype(np.int8)))
        lp.v.copy_(torch.from_numpy(rng.integers(-127, 128, tuple(lp.v.shape)).astype(np.int8)))
        lp.k_scale.fill_(0.01)
        lp.v_scale.fill_(0.01)
    for slot, n in enumerate(lengths):
        be.alloc.allocate(slot, n + 24, 32)
        be.alloc.lengths[slot] = n
    return be


def test_paged_graph_burst_equals_eager_steps(cuda):
    """A paged burst captured as a CUDA graph (K10 over the persistent page
    table and positions) gives the tokens of the uncaptured step run from
    the same state; replays credit K10's launches."""
    from quantumattention_tpu_torch.ops.paged import paged_decode_attention
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    cfg, params = _burst_model(cuda)
    lengths = [3, 0, 17, 40] + [9] * 12
    toks = np.arange(16) * 5 % cfg.vocab_size
    ones = np.ones(16, bool)
    be = _filled_paged_backend(cfg, cuda, lengths)
    before = paged_decode_attention.launches
    a = be.burst(params, toks, ones, np.full(16, 20, np.int32), np.full(16, -1, np.int32),
                 None, 6, SamplingParams(), False)
    b = be.burst(params, a[0][-1], ones, np.full(16, 20, np.int32), np.full(16, -1, np.int32),
                 None, 4, SamplingParams(), False)
    assert paged_decode_attention.launches - before == cfg.num_layers * 10
    assert be.stats == {"bursts": 2, "graph_captures": 1, "graph_replays": 9,
                        "step_captures": 0, "step_replays": 0}
    np.testing.assert_array_equal(be.host_lengths(), np.asarray(lengths) + 10)
    ref = _filled_paged_backend(cfg, cuda, lengths)
    steps = _uncaptured_steps(ref, params, toks, 10)
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]]), np.stack(steps))
    for x, y in zip(be.pages, ref.pages):
        assert torch.equal(x.k, y.k) and torch.equal(x.v_scale, y.v_scale)


def test_paged_prefix_engine_on_card_matches_cpu(cuda):
    """The paged, prefix-cached engine with chunked prefill (K1 with
    q_offset) and bursts (K10 in graphs) on the card against the CPU
    engine: first tokens and counters equal."""
    cfg, params = _burst_model("cpu")
    shared = list(range(1, 70))
    prompts = [shared + [3, 4], shared + [5], list(range(7, 30)), shared + [9, 9, 9]]
    outs, stats = {}, {}
    for dev in ("cpu", "cuda"):
        flags = {"kernel.qmlp": "force", "kernel.qmm": "force"} if dev == "cpu" else {}
        with qt.config.patch(flags):
            # 16 pages: the shared prefix's idle pages survive the short
            # prompt's reservation (a pool of 9 would evict them first).
            eng = Engine(_tree_on(params, dev), cfg, num_slots=2, max_len=128, num_pages=16,
                         cache_backend="paged", page_size=32, prefill_chunk=64, prefix_cache=True)
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_to_completion(decode_burst=4)
        assert all(r.done and len(r.output) == 6 for r in reqs)
        outs[dev], stats[dev] = [r.output[0] for r in reqs], dict(eng.stats)
    assert outs["cpu"] == outs["cuda"] and stats["cpu"] == stats["cuda"]
    assert stats["cuda"]["prefix_hits"] >= 1


def test_default_device_is_the_card_on_card(cuda):
    from quantumattention_tpu_torch.models import convert
    from quantumattention_tpu_torch.serving import kv_cache, paged_cache
    from quantumattention_tpu_torch.serving.backends import PagedBackend, SlotsBackend

    cfg = llama.tiny()
    assert kv_cache.init_cache(1, 2, 8, 64).k.device.type == "cuda"
    assert paged_cache.init_layer_pages(2, 4, 16, 64).k.device.type == "cuda"
    assert SlotsBackend(cfg, num_slots=1, max_len=8).device.type == "cuda"
    assert PagedBackend(cfg, num_slots=1, max_len=32, page_size=16).pages[0].k.is_cuda
    tree = {"embed": np.zeros((4, 2), np.float32), "final_norm": np.ones(2, np.float32),
            "layers": [{"attn_norm": np.ones(2, np.float32)} for _ in range(cfg.num_layers)]}
    assert convert.params_from_numpy(tree, cfg)["embed"].is_cuda


# ---------------------------------------------------------------------------
# Sliding windows and position offsets (K1-K4, K10)
# ---------------------------------------------------------------------------

K1_WINDOW_CASES = [  # (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_offset)
    (1, 8, 2, 300, 300, 128, True, (63, 0), 0, 0),
    (1, 8, 2, 300, 300, 64, True, (200, 0), 0, 0),
    (1, 4, 4, 257, 257, 256, True, (100, 0), 0, 0),
    (1, 4, 1, 200, 200, 512, True, (77, 0), 0, 0),
    (1, 8, 2, 200, 200, 128, False, (30, 17), 0, 0),
    (1, 8, 2, 100, 357, 128, True, (90, 0), 300, 43),
    (1, 4, 2, 96, 160, 64, False, (None, 20), 10, 60),   # rows 0-29 see no key
]


@pytest.mark.parametrize("mode", ["bf16", "fp16", "e4m3-head", "e4m3-token", "int8-head"])
@pytest.mark.parametrize("case", K1_WINDOW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_window_kernel_matches_plain(cuda, case, mode):
    """K1 with a window and position offsets against its plain version and
    the fp32 oracle (on the rows that see a key); rows that see no key are
    exact zeros, as JAX's kernel gives them."""
    b, hq, hkv, sq, skv, d, causal, window, q_off, kv_off = case
    fdt = torch.float16 if mode == "fp16" else torch.bfloat16
    q = _randn((b, hq, sq, d), 21, fdt, cuda)
    k = _randn((b, hkv, skv, d), 22, fdt, cuda)
    v = _randn((b, hkv, skv, d), 23, fdt, cuda)
    scales = {}
    if mode not in ("bf16", "fp16"):
        qdt = torch.float8_e4m3fn if mode.startswith("e4m3") else torch.int8
        fn = quant.quantize_head_wise if mode.endswith("head") else quant.quantize_token_wise
        (q, sq_), (k, sk_) = fn(q, qdt), fn(k, qdt)
        scales = {"scale_q": sq_, "scale_k": sk_}
    kw = dict(is_causal=causal, window=window, q_offset=q_off, kv_offset=kv_off, **scales)
    before = (flash_attention.launches, flash_attention.window_launches)
    out = flash_attention(q, k, v, **kw)
    assert (flash_attention.launches, flash_attention.window_launches) == (before[0] + 1,
                                                                           before[1] + 1)
    plain = flash_attention_plain(q, k, v, kw["scale_q"] if scales else None,
                                  kw["scale_k"] if scales else None, causal, None, False, q_off,
                                  window, kv_off)
    torch.cuda.synchronize()
    from quantumattention_tpu_torch.ops.flash import keep_mask

    seen = keep_mask(sq, skv, causal, window, q_off, kv_off, cuda).any(-1)
    oracle = sdpa_reference(q, k, v, attn_mask=keep_mask(sq, skv, causal, window, q_off, kv_off,
                                                         cuda),
                            out_dtype=torch.float32, **scales)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - plain.float()).abs().max()) <= ATOL
    assert bool((out[:, :, ~seen] == 0).all())
    rows = out.float()[:, :, seen] - oracle[:, :, seen]
    assert float(rows.pow(2).mean().sqrt()) < RMSE_BAR


WINDOW_BWD_SHAPES = [  # (B, Hq, Hkv, S, D, causal, window)
    (1, 8, 2, 300, 128, True, (63, 0)),
    (1, 4, 4, 257, 64, True, (150, 0)),
    (1, 4, 1, 200, 256, True, (40, 0)),
    (1, 8, 2, 200, 128, False, (30, 17)),
    (2, 4, 2, 130, 64, False, (None, 9)),
    (1, 4, 4, 100, 512, True, (33, 0)),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", WINDOW_BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_window_bwd_kernels_match_plain(cuda, shape, dtype):
    """K1's residuals, then K2 and K3 with a window, against their plain
    versions; each call counts as a window launch."""
    b, hq, hkv, s, d, causal, window = shape
    q = _randn((b, hq, s, d), 31, dtype, cuda)
    k = _randn((b, hkv, s, d), 32, dtype, cuda)
    v = _randn((b, hkv, s, d), 33, dtype, cuda)
    do = _randn((b, hq, s, d), 34, dtype, cuda)
    out, (m, l) = flash_attention(q, k, v, is_causal=causal, window=window, return_residuals=True)
    _, (pm, pl) = flash_attention_plain(q, k, v, is_causal=causal, window=window,
                                        return_residuals=True)
    before = (flash_bwd_dq.window_launches, flash_bwd_dkv.window_launches)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal, window=window)
    assert (flash_bwd_dq.window_launches, flash_bwd_dkv.window_launches) == (before[0] + 1,
                                                                             before[1] + 1)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 1e-3 if dtype == torch.bfloat16 else 3e-2
    assert float((m - pm).abs().max()) <= tol
    assert float(((l - pl).abs() / pl).max()) <= tol
    for g, p, t in zip(grads, plain, (q, k, v)):
        assert g.shape == t.shape and bool(torch.isfinite(g).all())
        assert _max_rel(g, p) < GRAD_BAR


def _window_call(cuda, kernel, kind, t, left):
    """(kernel call, plain call, lengths, wrapper) of one K4 or K10 call
    with window (left, 0), T = t query tokens a head (None: a 3-D query)."""
    from quantumattention_tpu_torch.ops.paged import (
        paged_decode_attention, paged_decode_attention_plain)

    if kernel == "k4":
        lengths = VERIFY_LENGTHS if t else DECODE_LENGTHS
        q, kc, vc, lens, ks, vs = _decode_case(cuda, kind, 4, 128, qtokens=t, lengths=lengths)
        return (lambda: decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs, window=(left, 0)),
                lambda: decode_attention_plain(q, kc, vc, lens, ks, vs, window_left=left), lens,
                decode_attention)
    q, k, v, lens, table, ks, vs = _paged_case(cuda, (16, 32, 8, 128, 8, 128), kind, qtokens=t)
    return (lambda: paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks,
                                           v_scale_pages=vs, pages_per_block=1, window=(left, 0)),
            lambda: paged_decode_attention_plain(q, k, v, lens, table, ks, vs, window_left=left),
            lens, paged_decode_attention)


@pytest.mark.parametrize("left", [0, 63, 300])
@pytest.mark.parametrize("t", [None, 5], ids=["t1", "t5"])
@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_decode_window_kernels_match_plain(cuda, kernel, kind, t, left):
    """K4 and K10 with a window (a row's first visible row inside a tile,
    on a tile edge, or lower), one token a head and verify mode, over
    every cache kind, against their plain versions within the decode bars;
    an empty slot gives zeros; the call counts as a window launch."""
    call, plain_call, lens, wrapper = _window_call(cuda, kernel, kind, t, left)
    before = wrapper.window_launches
    out = call()
    torch.cuda.synchronize()
    assert wrapper.window_launches == before + 1
    plain = plain_call()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    _assert_decode_close(out, plain, lens)
    assert torch.equal(call(), out)


@pytest.mark.parametrize("left", [0, 100, 4095])
@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("kernel", ["k4", "k10"])
def test_decode_core_window_split_is_the_schedule(cuda, kernel, kind, left):
    """With a window the card's partials are exactly the runs of
    ``decode_schedule(..., window_left=left)``: every slot's tiles start at
    the first that its query sees, so no tile below it is fetched."""
    from quantumattention_tpu_torch.ops import decode

    _, raw, lens, plan, smax = _core_calls(cuda, kernel, kind, window_left=left)
    acc, ml = decode.core_scratch(plan, lens.shape[0], cuda)
    ml.fill_(float("nan"))
    raw(acc, ml)
    torch.cuda.synchronize()
    written = set(torch.nonzero(torch.isfinite(ml[:, 0, 0])).flatten().tolist())
    sched = decode.decode_schedule(lens.cpu().numpy(), plan["segments"], decode.ROWS_PER_TILE,
                                   plan["ctas"], smax, window_left=left)
    assert written == {c + seg for c in range(sched.ctas) for seg, _, _ in sched.runs(c)}


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_window_engine_on_card(cuda, backend):
    """A ``tiny(window=16)`` model serves prompts longer than its window on
    the card through K1 (chunked, with kv_offset past the window) and K4 or
    K10 with the window; the first tokens equal the CPU engine's."""
    from quantumattention_tpu_torch.ops.paged import paged_decode_attention

    cfg = llama.tiny(window=16)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = [list(range(3, 40)), list(range(5, 75)), [7, 8, 9]]
    kw = dict(prefill_chunk=32)
    if backend == "paged":
        kw.update(cache_backend="paged", page_size=32)
    wrapper = paged_decode_attention if backend == "paged" else decode_attention
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(_params_on(params, dev), cfg, num_slots=2, max_len=256,
                     cache_dtype=torch.int8, **kw)
        k1, dec = flash_attention.window_launches, wrapper.window_launches
        reqs = [eng.submit(pr, max_new_tokens=6) for pr in prompts]
        eng.run_to_completion()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        if dev == "cuda":
            assert flash_attention.window_launches - k1 == cfg.num_layers * eng.stats["prefill_forwards"]
            assert wrapper.window_launches - dec == cfg.num_layers * eng.stats["decode_steps"]
        outs[dev] = [r.output[0] for r in reqs]
    assert outs["cpu"] == outs["cuda"]


# Per-block quantization (the quantizer kernel, csrc/block_quant.cu), K1's
# second tile configuration (csrc/flash_fwd_q2.cu) and the autotuner.


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    from quantumattention_tpu_torch import autotune

    monkeypatch.setenv("QUANTUM_ATTN_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    return autotune


BLOCK_QUANT_CASES = [  # (B, H, S, D, block rows, dtype)
    (1, 32, 1536, 128, 1024, torch.bfloat16),
    (2, 4, 200, 96, 128, torch.bfloat16),
    (1, 8, 77, 64, 50, torch.float16),
    (1, 2, 3000, 256, 2048, torch.float32),
    (2, 3, 513, 72, 64, torch.bfloat16),
    (1, 1, 1, 512, 512, torch.bfloat16),
]


@pytest.mark.parametrize("case", BLOCK_QUANT_CASES, ids=lambda c: "x".join(map(str, c[:5])) + str(c[5])[-4:])
def test_block_quant_kernel_bitwise(cuda, case):
    """Codes, block scales and row scales equal the plain version's, bit
    for bit, on the same card tensor (an outlier row in the first block)."""
    b, h, s, d, rows, dtype = case
    x = _randn((b, h, s, d), 7, torch.float32, cuda) * 3
    x[:, :, 0] *= 40
    x = x.to(dtype)
    before = quant.block_quant.launches
    codes, scales, row_scales = quant.block_quant(x, rows)
    assert quant.block_quant.launches == before + 1
    want_codes, want_scales = quant.quantize_block_wise(x, rows)
    torch.cuda.synchronize()
    width = -(-d // 16) * 16
    assert codes.shape == (b, h, s, width)
    assert torch.equal(codes[..., :d].view(torch.uint8), want_codes.view(torch.uint8))
    assert not codes[..., d:].view(torch.uint8).any()
    assert torch.equal(scales, want_scales)
    assert torch.equal(row_scales, quant.expand_block_scales(want_scales, rows, s))


PER_BLOCK_CASES = [  # (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, kv_offset, blocks)
    (1, 8, 2, 300, 300, 128, True, None, 0, 0, (128, 128)),
    (1, 4, 4, 200, 200, 64, False, None, 0, 0, None),
    (2, 4, 1, 257, 257, 96, True, (64, 0), 0, 0, (64, 200)),
    (1, 4, 2, 100, 250, 128, True, None, 150, 0, (1024, 2048)),
    (1, 4, 2, 64, 180, 72, True, (100, 0), 300, 180, (128, 128)),
]


@pytest.mark.parametrize("tiles", [0, 1])
@pytest.mark.parametrize("case", PER_BLOCK_CASES, ids=lambda c: "x".join(map(str, c[:7])))
def test_flash_per_block_kernel_matches_plain(cuda, tmp_cache, case, tiles):
    """The quantizer kernel then K1 (token-wise over the row scales) at
    each tile configuration (forced through the autotuner's cache) against
    the plain version, and bitwise repeatable."""
    from quantumattention_tpu_torch.ops import flash as flash_mod

    b, hq, hkv, sq, skv, d, causal, window, q_off, kv_off, blocks = case
    q = _randn((b, hq, sq, d), 1, torch.bfloat16, cuda)
    k = _randn((b, hkv, skv, d), 2, torch.bfloat16, cuda)
    v = _randn((b, hkv, skv, d), 3, torch.bfloat16, cuda)
    kw = dict(is_causal=causal, q_offset=q_off, kv_offset=kv_off)
    if blocks:
        kw.update(block_q=blocks[0], block_kv=blocks[1])
    window = flash_mod.kernel_window(window, causal)
    key = flash_mod._tile_key(q, k, None, True, causal, window)
    tmp_cache.record(key, *tmp_cache.K1_TILES[flash_mod.shapes.kernel_width(d)][tiles])
    before, bq_before = flash_attention.launches, flash_attention.block_quant_launches
    out = flash_attention(q, k, v, fused_block_quant=True, window=window, **kw)
    again = flash_attention(q, k, v, fused_block_quant=True, window=window, **kw)
    assert flash_attention.launches == before + 2
    assert flash_attention.block_quant_launches == bq_before + 4
    plain = flash_attention_plain(q, k, v, fused_block_quant=True, window=window, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert float((out.float() - plain.float()).abs().max()) <= ATOL


@pytest.mark.parametrize("mode", ["bf16", "fp16", "e4m3-head", "e4m3-token", "int8-head", "e4m3-v"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_second_tile_config_matches_plain(cuda, tmp_cache, shape, mode):
    """K1's tile configuration 1 (two consumer warpgroups, KV tiles of 128
    rows) at widths 64 and 128 for every Q/K type, against the plain
    version, and bitwise repeatable."""
    from quantumattention_tpu_torch.ops import flash as flash_mod

    b, hq, hkv, sq, skv, d, causal = shape
    fdt = torch.float16 if mode == "fp16" else torch.bfloat16
    q = _randn((b, hq, sq, d), 4, fdt, cuda)
    k = _randn((b, hkv, skv, d), 5, fdt, cuda)
    v = _randn((b, hkv, skv, d), 6, fdt, cuda)
    scales = {}
    if mode == "e4m3-v":
        v = v.to(torch.float8_e4m3fn)
    elif mode not in ("bf16", "fp16"):
        qdt = torch.float8_e4m3fn if mode.startswith("e4m3") else torch.int8
        fn = quant.quantize_head_wise if mode.endswith("head") else quant.quantize_token_wise
        (q, sq_), (k, sk_) = fn(q, qdt), fn(k, qdt)
        scales = {"scale_q": sq_, "scale_k": sk_}
    key = flash_mod._tile_key(q, k, scales.get("scale_q"), False, causal, None)
    tmp_cache.record(key, 128, 128)
    out = flash_attention(q, k, v, is_causal=causal, **scales)
    again = flash_attention(q, k, v, is_causal=causal, **scales)
    plain = flash_attention_plain(q, k, v, is_causal=causal, **scales)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert float((out.float() - plain.float()).abs().max()) <= ATOL


def test_k1_smem_mirror(cuda):
    """``autotune.k1_smem_bytes`` (the Python fit model) equals each
    instantiation's ``Cfg::kSmem``."""
    from quantumattention_tpu_torch import autotune
    from quantumattention_tpu_torch.ops import _native

    lib = _native.library()
    for width, configs in autotune.K1_TILES.items():
        for code, es in ((0, 2), (1, 2), (2, 1), (3, 1)):
            for tiles in (0, 1, 2):
                got = lib.qa_flash_fwd_smem(width, code, tiles)
                if tiles < len(configs):
                    assert got == autotune.k1_smem_bytes(*configs[tiles], width, es), (width, code, tiles)
                    assert autotune.smem_fits(*configs[tiles], width, es)
                else:
                    assert got == 0


def test_autotune_capture_guard_and_cache_hit(cuda, tmp_cache):
    """Under graph capture a per-block call and an "auto" call sweep
    nothing and take the defaults; eagerly the first call of a shape class
    sweeps, the second times nothing."""
    autotune = tmp_cache
    q = _randn((1, 8, 256, 128), 1, torch.bfloat16, cuda)
    k = _randn((1, 2, 256, 128), 2, torch.bfloat16, cuda)
    v = _randn((1, 2, 256, 128), 3, torch.bfloat16, cuda)
    flash_attention(q, k, v, fused_block_quant=True, is_causal=True)  # build, warm up
    q2 = _randn((1, 8, 320, 128), 4, torch.bfloat16, cuda)
    k2 = _randn((1, 2, 320, 128), 5, torch.bfloat16, cuda)
    v2 = _randn((1, 2, 320, 128), 6, torch.bfloat16, cuda)
    sweeps, misses = autotune.sweeps, autotune.misses_in_capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = flash_attention(q2, k2, v2, fused_block_quant=True, is_causal=True)
        auto = qt.fp8_attn_func(q2, k2, v2, is_causal=True, scaling_method="auto")
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    # The per-block call's tiles, the "auto" path, and its per-block call's tiles.
    assert autotune.sweeps == sweeps and autotune.misses_in_capture == misses + 3
    assert torch.equal(out, auto)
    assert not [key for key in autotune._load_cache() if "sq320" in key]  # nothing recorded
    eager = qt.fp8_attn_func(q2, k2, v2, is_causal=True, scaling_method="auto")
    assert autotune.sweeps > sweeps and autotune.timed > 0
    timed = autotune.timed
    again = qt.fp8_attn_func(q2, k2, v2, is_causal=True, scaling_method="auto")
    torch.cuda.synchronize()
    assert autotune.timed == timed and torch.equal(eager, again)
    assert any("|path|" in key for key in autotune._load_cache())


# ---------------------------------------------------------------------------
# K1's modes: segment ids, block masks, int8 V
# ---------------------------------------------------------------------------

K1_MODES = ["segments", "block_mask", "int8_v"]


def _k1_mode_args(mode, b, sq, skv, v, seed=0):
    """The keyword arguments of ``mode`` for (b, sq, skv), with v as the
    call takes it (int8 codes for "int8_v"), and the counter it bumps."""
    g = torch.Generator().manual_seed(seed)
    dev = v.device
    if mode == "segments":
        # Sorted ids with a gap: kv ids skip 2, so rows of segment 2 see no key.
        q_ids = torch.sort(torch.randint(0, 4, (b, sq), generator=g), dim=1).values
        kv_ids = torch.sort(torch.randint(0, 4, (b, skv), generator=g), dim=1).values
        kv_ids[kv_ids == 2] = 3
        return v, {"q_segment_ids": q_ids.to(dev), "kv_segment_ids": kv_ids.to(dev)}, "segment_launches"
    if mode == "block_mask":
        bm = torch.rand((-(-sq // 128), -(-skv // 128)), generator=g) < 0.6
        bm[0] = False  # the first granule row sees no key
        if bm.shape[0] > 1:
            bm[1, 0] = True
        return v, {"block_mask": bm.to(dev)}, "block_mask_launches"
    v8, sv = quant.quantize_channel_wise(v.float(), torch.int8)
    return v8, {"scale_v": sv}, "int8_v_launches"


def _k1_mode_check(cuda, mode, b, hq, hkv, sq, skv, d, causal, window=None, scaling="none",
                   residuals=False, seed=41):
    q = _randn((b, hq, sq, d), seed, torch.bfloat16, cuda)
    k = _randn((b, hkv, skv, d), seed + 1, torch.bfloat16, cuda)
    v = _randn((b, hkv, skv, d), seed + 2, torch.bfloat16, cuda)
    v, kw, counter = _k1_mode_args(mode, b, sq, skv, v, seed)
    scales = {}
    if scaling in ("e4m3-head", "int8-token"):
        qdt = torch.float8_e4m3fn if scaling.startswith("e4m3") else torch.int8
        fn = quant.quantize_head_wise if scaling.endswith("head") else quant.quantize_token_wise
        (q, sq_), (k, sk_) = fn(q, qdt), fn(k, qdt)
        scales = {"scale_q": sq_, "scale_k": sk_}
    elif scaling == "per-block":
        scales = {"fused_block_quant": True}
    before = (flash_attention.launches, getattr(flash_attention, counter))
    res = flash_attention(q, k, v, is_causal=causal, window=window, return_residuals=residuals,
                          **scales, **kw)
    assert (flash_attention.launches, getattr(flash_attention, counter)) == (before[0] + 1,
                                                                             before[1] + 1)
    plain = flash_attention_plain(q, k, v, is_causal=causal, window=window,
                                  return_residuals=residuals, **scales, **kw)
    torch.cuda.synchronize()
    out, pout = (res[0], plain[0]) if residuals else (res, plain)
    assert out.dtype == pout.dtype and out.shape == pout.shape
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - pout.float()).abs().max()) <= ATOL
    keep = flash_mod.keep_mask(sq, skv, causal, window, 0, 0, cuda, kw.get("q_segment_ids"),
                               kw.get("kv_segment_ids"), kw.get("block_mask"))
    if keep is not None:
        rows = keep.any(-1).expand(b, hq, sq)
        assert not bool(out[~rows].any())  # rows that see no key: exact zeros
    if residuals:
        seen = rows if keep is not None else torch.ones((b, hq, sq), dtype=torch.bool, device=cuda)
        fp8 = scaling in ("e4m3-head", "per-block")
        m_bar, l_bar = (FP8_RESIDUAL_M_ATOL, FP8_RESIDUAL_L_RTOL) if fp8 else (1e-3, 1e-3)
        (m, l), (pm, pl) = res[1], plain[1]
        assert float((m - pm)[seen].abs().max()) <= m_bar
        assert float(((l - pl).abs() / pl)[seen].max()) <= l_bar
    return out


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 96, 128, 256, 512])
@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_modes_match_plain(cuda, mode, d, causal):
    """Each mode at every width against the plain version (1/32), rows that
    see no key exact zeros, one launch counted on the mode's counter."""
    _k1_mode_check(cuda, mode, 2, 4, 2, 300, 333, d, causal)


K1_MODE_COMBOS = {  # name: (B, Hq, Hkv, Sq, Skv, D, causal, window, scaling, residuals)
    "window": (1, 4, 2, 400, 400, 128, True, (150, 0), "none", False),
    "window2": (1, 4, 2, 300, 350, 64, False, (100, 60), "none", False),
    "gqa8": (1, 8, 1, 257, 257, 128, True, None, "none", False),
    "e4m3_head": (2, 4, 2, 300, 300, 128, True, None, "e4m3-head", False),
    "int8_token": (1, 4, 4, 200, 260, 64, False, None, "int8-token", False),
    "per_block": (1, 4, 2, 384, 384, 128, True, None, "per-block", False),
    "residuals": (1, 4, 2, 300, 300, 128, True, None, "none", True),
    "residuals_d256": (1, 2, 2, 200, 200, 256, False, None, "none", True),
}


@pytest.mark.parametrize("combo", sorted(K1_MODE_COMBOS))
@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_modes_combine(cuda, mode, combo):
    """Each mode with windows, GQA, head-wise / token-wise / per-block
    scaling and the residuals, against the plain version."""
    _k1_mode_check(cuda, mode, *K1_MODE_COMBOS[combo])


def test_k1_modes_combine_with_each_other(cuda):
    q = _randn((2, 4, 300, 128), 51, torch.bfloat16, cuda)
    k = _randn((2, 2, 300, 128), 52, torch.bfloat16, cuda)
    v = _randn((2, 2, 300, 128), 53, torch.bfloat16, cuda)
    v8, kw, _ = _k1_mode_args("int8_v", 2, 300, 300, v)
    _, seg, _ = _k1_mode_args("segments", 2, 300, 300, v)
    _, bm, _ = _k1_mode_args("block_mask", 2, 300, 300, v)
    kw.update(seg, **bm)
    out = flash_attention(q, k, v8, is_causal=True, **kw)
    plain = flash_attention_plain(q, k, v8, is_causal=True, **kw)
    torch.cuda.synchronize()
    assert float((out.float() - plain.float()).abs().max()) <= ATOL


@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_modes_refuse_tile_configuration_1(cuda, mode, monkeypatch):
    q = _randn((1, 2, 256, 128), 61, torch.bfloat16, cuda)
    v, kw, _ = _k1_mode_args(mode, 1, 256, 256, q)
    monkeypatch.setattr(flash_mod, "_k1_tiles", lambda *a, **k: 1)
    with pytest.raises(ValueError, match="tile configuration 1"):
        flash_attention(q, q, v, **kw)


def test_k1_block_mask_graph_replay_is_eager(cuda):
    """A graph-captured call with the mask on the card (the tile list built
    inside the graph) gives the eager call's bits, and follows a new mask
    copied into the same tensor."""
    q = _randn((1, 8, 1000, 128), 71, torch.bfloat16, cuda)
    k = _randn((1, 2, 1000, 128), 72, torch.bfloat16, cuda)
    v = _randn((1, 2, 1000, 128), 73, torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(74)
    masks = [(torch.rand((8, 8), generator=g) < 0.4).to(cuda) for _ in range(2)]
    bm = masks[0].clone()
    call = lambda: flash_attention(q, k, v, is_causal=True, block_mask=bm)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for mask in masks:
        bm.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, flash_attention(q, k, v, is_causal=True, block_mask=mask))


@pytest.mark.parametrize("d", [64, 128, 256, 512])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_k1_trivial_masks_are_the_dense_call(cuda, monkeypatch, causal, d):
    """An all-ones block mask and segment ids that are all equal visit the
    same tiles in the same order and mask nothing: the dense call's bits."""
    monkeypatch.setattr(flash_mod, "_k1_tiles", lambda *a, **k: 0)
    q = _randn((2, 4, 333, d), 81, torch.bfloat16, cuda)
    k = _randn((2, 2, 333, d), 82, torch.bfloat16, cuda)
    v = _randn((2, 2, 333, d), 83, torch.bfloat16, cuda)
    dense = flash_attention(q, k, v, is_causal=causal)
    ones = flash_attention(q, k, v, is_causal=causal,
                           block_mask=torch.ones((3, 3), dtype=torch.bool, device=cuda))
    ids = torch.full((2, 333), 7, dtype=torch.int32, device=cuda)
    same = flash_attention(q, k, v, is_causal=causal, q_segment_ids=ids, kv_segment_ids=ids)
    torch.cuda.synchronize()
    assert torch.equal(dense, ones) and torch.equal(dense, same)


def test_k1_block_table_on_card_is_the_cpu_one(cuda):
    g = torch.Generator().manual_seed(91)
    bm = torch.rand((20, 17), generator=g) < 0.3
    for (rows, cols) in {c[0] for c in flash_mod.autotune.K1_TILES.values()}:
        for causal, window in ((True, None), (False, (500, 300)), (True, (700, 0))):
            want = flash_mod.block_table(bm, 2500, 2100, rows, cols, causal, window)
            got = flash_mod.block_table(bm.to(cuda), 2500, 2100, rows, cols, causal, window)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The attention fuzz (tests/torch_fuzz_draws.py) on the card: K1 (with its
# modes), K2/K3 and K4 against their plain versions on the same inputs
# (the wrappers on CPU copies run the plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_flash_kernel_matches_plain(cuda, seed):
    import torch_fuzz_draws as draws

    c = draws.forward_case(seed)
    q, k, v, kw = draws.forward_inputs(c, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, is_causal=c["is_causal"], window=c["window"], **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 1
    cq, ck, cv, ckw = draws.to_cpu((q, k, v, kw))
    plain = flash_attention(cq, ck, cv, is_causal=c["is_causal"], window=c["window"], **ckw)
    err = float(((out.cpu().float() - plain.float()) ** 2).mean().sqrt())
    assert err < RMSE_BAR, f"{c}: rmse={err}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_flash_backward_matches_plain(cuda, seed):
    import torch_fuzz_draws as draws
    from quantumattention_tpu_torch.ops.autodiff import attention_with_vjp

    c = draws.backward_case(seed)
    inputs = [_randn(s, 1000 + seed + i, torch.bfloat16, cuda) for i, s in enumerate(
        [(1, c["hq"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"])])]
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    grads = []
    for dev_inputs in (inputs, draws.to_cpu(inputs)):
        leaves = [t.clone().requires_grad_(True) for t in dev_inputs]
        out = attention_with_vjp(*leaves, is_causal=c["is_causal"])
        grads.append(torch.autograd.grad((out.float() ** 2).sum(), leaves))
    assert (flash_bwd_dq.launches - before[0], flash_bwd_dkv.launches - before[1]) == (1, 1)
    for name, a, b in zip("qkv", *grads):
        err = float((a.cpu().float() - b.float()).abs().max() / b.float().abs().max())
        assert err < GRAD_BAR, f"{c} d{name}: {err}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_decode_kernel_matches_plain(cuda, seed):
    import torch_fuzz_draws as draws

    c = draws.decode_case(seed)
    q, kc, vc, lengths, kw = draws.decode_inputs(c, cuda)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lengths, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches - before == 1
    plain = decode_attention(*draws.to_cpu((q, kc, vc, lengths)), **draws.to_cpu(kw))
    _assert_decode_close(out.cpu(), plain, lengths.cpu())


# ---------------------------------------------------------------------------
# MoE (models/moe.py) and Hugging Face checkpoints on the card
# ---------------------------------------------------------------------------


_EXPERT_STACKS = {}


def _expert_stacks(dev):
    """Mixtral's expert stacks of one layer: 8 experts, 4096 -> 14336 (up)
    and 14336 -> 4096 (down), int8 with per-expert column scales; drawn
    once."""
    from quantumattention_tpu_torch.models import quantized

    if not _EXPERT_STACKS:
        g = torch.Generator(device=dev).manual_seed(95)
        for name, (k, n) in (("up", (4096, 14336)), ("down", (14336, 4096))):
            _EXPERT_STACKS[name] = quantized.quantize_matrix(torch.randn((8, k, n), generator=g, device=dev) / k ** 0.5)
    return _EXPERT_STACKS


@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("c_rows", [8, 24, 472])
def test_expert_products_run_k5_per_expert(cuda, direction, c_rows):
    """A 3-D int8 stack's product: one K5/K6 launch an expert on the
    register-A wgmma kernel (never a product over dequantized codes), each
    expert's rows within 2^-6 of the fp32 einsum over the dequantized
    stack, and a graph replay bitwise equal to the eager call."""
    from quantumattention_tpu_torch.models import quantized
    from quantumattention_tpu_torch.ops import qmm

    w = _expert_stacks(cuda)[direction]
    x = _randn((8, c_rows, w["q"].shape[1]), 96 + c_rows, torch.bfloat16, cuda)
    routes = dict(qmm.route_launches)
    counts = qmm.quantized_matmul.launches + qmm.quantized_matmul.splitk_launches
    call = lambda: quantized.matmul(x, w)  # noqa: E731
    out = call()
    torch.cuda.synchronize()
    assert qmm.route_launches["wgmma"] - routes["wgmma"] == 8
    assert qmm.quantized_matmul.launches + qmm.quantized_matmul.splitk_launches - counts == 8
    ref = torch.matmul(x.float(), w["q"].float() * w["s"])
    for e in range(8):
        _close_rel(out[e], ref[e].to(torch.bfloat16))
    assert torch.equal(_graph_call(call), out)


def _moe_tree(dev, experts=4):
    from quantumattention_tpu_torch.models import quantized

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                            num_q_heads=8, num_kv_heads=2, head_dim=128, num_experts=experts)
    tree = quantized.fuse_projections(quantized.init_quantized_params(torch.Generator().manual_seed(2), cfg))
    return cfg, _tree_on(tree, dev)


def test_moe_layer_launches_3e_products(cuda):
    from quantumattention_tpu_torch.models import moe
    from quantumattention_tpu_torch.ops import qmm

    cfg, tree = _moe_tree(cuda, experts=8)
    layer = tree["layers"][0]["moe"]
    x = _randn((3, 50, cfg.hidden_size), 97, torch.bfloat16, cuda)
    before = qmm.route_launches["wgmma"]
    y = moe.moe_ffn(layer, x, num_experts_per_tok=2, capacity_factor=1.25)
    torch.cuda.synchronize()
    assert qmm.route_launches["wgmma"] - before == 3 * cfg.num_experts
    with qt.config.patch({"kernel.qmm": False}):
        ref = moe.moe_ffn(layer, x, num_experts_per_tok=2, capacity_factor=1.25)
    assert float((y.float() - ref.float()).norm() / ref.float().norm()) < 2e-2


def test_moe_decode_step_graph_equals_eager(cuda):
    """A captured burst of an int8 MoE tree (the unfused step: neither K8
    nor K9 takes MoE) gives the tokens of the uncaptured step from the same
    state, and one captured step's logits equal the eager step's bit for
    bit."""
    from quantumattention_tpu_torch.ops import megastep, qmlp
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    cfg, params = _moe_tree(cuda)
    lengths = [3, 0, 17, 40] + [9] * 12
    toks = np.arange(16) * 5 % cfg.vocab_size
    ones = np.ones(16, bool)
    be = _filled_backend(cfg, cuda, lengths)
    assert be.route(params) == "unfused"
    k8, k9 = qmlp.fused_layer_tail.launches, megastep.fused_decode_layer.launches
    a = be.burst(params, toks, ones, np.full(16, 20, np.int32), np.full(16, -1, np.int32), None, 6,
                 SamplingParams(), False)
    assert be.stats["graph_captures"] == 1 and be.stats["graph_replays"] == 5
    assert (qmlp.fused_layer_tail.launches, megastep.fused_decode_layer.launches) == (k8, k9)
    ref = _filled_backend(cfg, cuda, lengths)
    steps = _uncaptured_steps(ref, params, toks, 6)
    np.testing.assert_array_equal(a[0], np.stack(steps))
    one = _filled_backend(cfg, cuda, lengths)
    saved = [c.lengths.clone() for c in one.caches]
    tokens = torch.as_tensor(toks, device=cuda)
    active = torch.ones(16, dtype=torch.bool, device=cuda)

    def restore():
        for c, n in zip(one.caches, saved):
            c.lengths.copy_(n)

    with torch.no_grad():
        eager = one._step(params, tokens, active)
        restore()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            one._step(params, tokens, active)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        restore()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = one._step(params, tokens, active)
        restore()
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def _draft_model(dev):
    """``_spec_model``'s draft: a 1-layer bf16 tree at head dim 64."""
    _, _, dparams, dcfg = _spec_model(dev)
    return dcfg, dparams


#: The single step's graph on each route: backend, tree, and the route
#: taken.  "draft" feeds each call the previous call's argmax as a device
#: tensor, gamma + 1 = 5 calls in a row, as a speculative round's draft does.
STEP_GRAPH_CASES = {
    "k9": (_filled_backend, _burst_model, True, "mega"),
    "int8_unfused": (_filled_backend, _burst_model, False, "unfused"),
    "moe": (_filled_backend, _moe_tree, True, "unfused"),
    "paged": (_filled_paged_backend, _burst_model, True, "paged"),
    "draft": (_filled_backend, _draft_model, True, "unfused"),
}


@pytest.mark.parametrize("case", list(STEP_GRAPH_CASES))
def test_step_graph_replays_equal_uncaptured_steps(cuda, case):
    """``decode`` on the card, n calls: the first eager, the second captures
    the step and replays it, the rest replay (``step_captures`` 1,
    ``step_replays`` n - 1, the burst counters untouched).  Each call's
    logits equal the uncaptured ``_step``'s from the same state and tokens
    bit for bit, and stay so through the later calls (a copy, not the
    graph's buffer); the launch counters move as for n uncaptured steps; the
    caches end equal, and the paged host lengths advance every call."""
    from quantumattention_tpu_torch.serving.backends import _launch_counters

    make, model, megastep_flag, route = STEP_GRAPH_CASES[case]
    lengths = [3, 0, 17, 40] + [9] * 12
    n = 5
    with qt.config.patch({"kernel.megastep": megastep_flag}):
        cfg, params = model(cuda)
        be, ref = make(cfg, cuda, lengths), make(cfg, cuda, lengths)
        assert be.route(params) == route
        counters = _launch_counters()

        def launched():
            return [getattr(fn, attr) for fn, attr in counters]

        ones = np.ones(16, bool)
        cur = np.arange(16) * 5 % cfg.vocab_size
        if case == "draft":
            cur = torch.as_tensor(cur, device=cuda)
        rows, outs, snaps = [], [], []
        before = launched()
        for _ in range(n):
            rows.append(cur)
            outs.append(be.decode(params, cur, ones))
            snaps.append(outs[-1].clone())
            cur = outs[-1].argmax(-1)
            if case != "draft":
                cur = cur.cpu().numpy()
        moved = [b - a for a, b in zip(before, launched())]
        if hasattr(ref, "_load_tables"):
            ref._load_tables()
        active = torch.ones(16, dtype=torch.bool, device=cuda)
        before = launched()
        with torch.no_grad():
            want = [ref._step(params, torch.as_tensor(r, dtype=torch.int64, device=cuda), active)
                    for r in rows]
        assert moved == [b - a for a, b in zip(before, launched())] and any(moved)
    torch.cuda.synchronize()
    assert be.stats == {"bursts": 0, "graph_captures": 0, "graph_replays": 0,
                        "step_captures": 1, "step_replays": n - 1}
    for i, (got, snap, exp) in enumerate(zip(outs, snaps, want)):
        assert torch.equal(got, snap) and torch.equal(got, exp), i
    if case == "paged":
        np.testing.assert_array_equal(be.host_lengths(), np.asarray(lengths) + n)
        for x, y in zip(be.pages, ref.pages):
            assert torch.equal(x.k, y.k) and torch.equal(x.v, y.v) and torch.equal(x.k_scale, y.k_scale)
    else:
        for x, y in zip(be.caches, ref.caches):
            assert torch.equal(x.lengths, y.lengths) and torch.equal(x.k, y.k) and torch.equal(x.v, y.v)


def test_step_graph_follows_a_flag_change(cuda):
    """After a step graph of the unfused int8 route is captured with K8
    (``kernel.qmlp`` on), a call with the flag off runs the step without K8
    (a graph of its own, first eager) and gives the uncaptured step's
    logits under that flag bit for bit; back on, the first graph replays."""
    from quantumattention_tpu_torch.ops import qmlp

    lengths = [3, 0, 17, 40] + [9] * 12
    ones = np.ones(16, bool)
    active = torch.ones(16, dtype=torch.bool, device=cuda)
    with qt.config.patch({"kernel.megastep": False}):
        cfg, params = _burst_model(cuda)
        be, ref = _filled_backend(cfg, cuda, lengths), _filled_backend(cfg, cuda, lengths)
        cur = np.arange(16) * 5 % cfg.vocab_size
        got, want, k8 = [], [], []
        for flag in (True, True, False, False, True):
            with qt.config.patch({"kernel.qmlp": flag}), torch.no_grad():
                before = qmlp.fused_layer_tail.launches
                got.append(be.decode(params, cur, ones))
                k8.append(qmlp.fused_layer_tail.launches - before)
                want.append(ref._step(params, torch.as_tensor(cur, dtype=torch.int64, device=cuda), active))
            cur = want[-1].argmax(-1).cpu().numpy()
    torch.cuda.synchronize()
    assert k8 == [cfg.num_layers, cfg.num_layers, 0, 0, cfg.num_layers]
    assert be.stats["step_captures"] == 2 and be.stats["step_replays"] == 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


def test_engine_step_graph_on_card_matches_cpu(cuda, monkeypatch):
    """Two slots and five prompts: eager steps run between the prefill
    forwards, replayed from the step's graph on the card.  The card engine
    gives the CPU engine's first tokens and counters, and every token of
    the same card engine with its graphs off (``_graphs`` false, the
    uncaptured steps)."""
    from quantumattention_tpu_torch.serving import backends

    cfg, params = _burst_model("cpu")
    prompts = [[3, 17, 42, 99, 7], [5, 9, 23, 51], list(range(1, 40)), [8, 8, 2], list(range(60, 90))]

    def serve(dev):
        flags = {"kernel.megastep": "force", "kernel.qmlp": "force", "kernel.qmm": "force"} if dev == "cpu" else {}
        with qt.config.patch(flags):
            eng = Engine(_tree_on(params, dev), cfg, num_slots=2, max_len=64)
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_to_completion(decode_burst=4)
        assert all(r.done and len(r.output) == 8 for r in reqs)
        return eng, [r.output for r in reqs]

    cpu, cpu_out = serve("cpu")
    card, card_out = serve("cuda")
    bs = card._backend.stats
    assert card.timings["eager_steps"] == cpu.timings["eager_steps"] > len(prompts)
    assert bs["step_captures"] == 1 and bs["step_replays"] == card.timings["eager_steps"] - 1
    assert [o[0] for o in card_out] == [o[0] for o in cpu_out] and card.stats == cpu.stats
    monkeypatch.setattr(backends, "_graphs", lambda backend: False)
    plain, plain_out = serve("cuda")
    assert plain._backend.stats["step_replays"] == 0 and card_out == plain_out


@pytest.mark.parametrize("mode", [True, "int4"], ids=["int8", "int4"])
def test_from_hf_on_card(cuda, tmp_path, mode):
    """A Mixtral checkpoint directory (tests/torch_hf_checkpoint.py) loads with
    Engine.from_hf on the card, quantized as it is read: equal to
    params_from_hf over the same tensors in memory bit for bit (int4: the
    attention projections w4a16, the expert stacks int8), and serves."""
    import torch_hf_checkpoint as ckpt

    from quantumattention_tpu_torch.models import hf, quantized

    cfg = llama.mixtral_8x7b(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                             num_q_heads=8, num_kv_heads=2, num_experts=4)
    sd = ckpt.mixtral_hf_state_dict(cfg, torch.Generator(device=cuda).manual_seed(98), device=cuda)
    ckpt.write_mixtral_checkpoint(str(tmp_path), cfg, sd)
    eng = Engine.from_hf(str(tmp_path), quantize_weights=mode, num_slots=2, max_len=256, device=cuda)
    assert eng.cfg == cfg and eng.device.type == "cuda"
    ref = hf.params_from_hf(sd, cfg, quantize=mode, device=cuda)
    for a, b in ckpt.tree_pairs(eng.params, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    layer = eng.params["layers"][0]
    assert quantized.is_quantized4(layer["wq"]) == (mode == "int4") and quantized.is_quantized(layer["moe"]["w_up"])
    reqs = [eng.submit([3, 7, 11, 19], max_new_tokens=5), eng.submit(list(range(1, 200)), max_new_tokens=4)]
    eng.run_to_completion()
    assert [len(r.output) for r in reqs] == [5, 4]


# ---------------------------------------------------------------------------
# The parallel layer on the card: two gloo ranks sharing cuda:0
# (tests/torch_dist_worker.py's "cuda" suite; one card gives correctness,
# no scaling figure)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_world(tmp_path_factory):
    if not checks.cuda_available() or not checks.is_hopper(0):
        pytest.skip("needs a Hopper CUDA device")
    from torch_dist_worker import World

    w = World(2, tmp_path_factory.mktemp("card_world"),
              {"ring_fp8_token_wise_card": {}, "tp_decode_card": {}, "tp_train_card": {}}, timeout_s=300.0)
    yield w
    w.close()


def test_ring_fp8_token_wise_on_two_ranks(cuda, card_world):
    """Ring attention over e4m3 token-wise shards on two ranks: K1 runs on
    the card (one launch a shard at or below each rank's diagonal, 3 in
    all), within 1/32 of one unsharded K1 call and under the RMSE bar of
    the fp32 oracle on the same codes."""
    res = card_world.case("ring_fp8_token_wise_card")
    assert all(r["device"].startswith("cuda") for r in res)
    assert [int(r["launches"]) for r in res] == [1, 2]
    out = torch.cat([r["out"] for r in res], dim=2).float()
    whole = res[0]["whole"].float()
    assert float((out - whole).abs().max()) <= ATOL
    r0 = res[0]
    ref = sdpa_reference(r0["q8"], r0["k8"], r0["v"], is_causal=True, scale_q=r0["sq"], scale_k=r0["sk"])
    assert float((out - ref.float()).pow(2).mean().sqrt()) < RMSE_BAR


def test_tp_decode_on_two_ranks(cuda, card_world):
    """K4 on each rank's 16/4 heads of an int8 cache (0/57/900/2047 rows)
    equals one unsharded K4 call within the decode bars."""
    res = card_world.case("tp_decode_card")
    assert all(int(r["launches"]) == 1 for r in res)
    out = torch.cat([r["out"] for r in res], dim=1)
    _assert_decode_close(out, res[0]["whole"], res[0]["lens"])


def test_tp_train_step_on_two_ranks(cuda, card_world):
    """One ``train_step(mesh=)`` of ``tiny`` on a (dp 1, tp 2) mesh: K1, K2
    and K3 launched on each rank's heads; the loss within 1e-2 relative,
    every gradient leaf (the shards put back together) and the SGD step of
    every leaf within 5e-2 relative Frobenius of one card's step through
    the same kernels (tests/test_torch_train.py's bars); the replicated
    leaves the same bytes on both ranks."""
    from quantumattention_tpu_torch.parallel import mesh as qmesh

    res = sorted(card_world.case("tp_train_card"), key=lambda r: r["tp"])
    assert all(r["device"].startswith("cuda") and min(r["launches"]) > 0 for r in res)
    r0 = res[0]
    for key in ("loss", "step_loss"):
        assert abs(r0[key] - r0["one_loss"]) <= 1e-2 * abs(r0["one_loss"]) and res[1][key] == r0[key]
    specs = qmesh.llama_param_specs(llama.tiny())

    def pairs(tree, whole, spec, path=""):
        if isinstance(tree, dict):
            for k in tree:
                yield from pairs(tree[k], whole[k], spec[k], f"{path}{k}.")
        elif isinstance(tree, list):
            for i, (t, w, s) in enumerate(zip(tree, whole, spec)):
                yield from pairs(t, w, s, f"{path}{i}.")
        else:
            yield path[:-1], tree, whole, spec

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    for key, one_key in (("grads", "one_grads"), ("new", "one_new")):
        for path, t0, want, spec in pairs(res[0][key], res[0][one_key], specs):
            t1 = next(t for p, t, _, _ in pairs(res[1][key], res[1][one_key], specs) if p == path)
            dims = [d for d, ax in enumerate(spec) if ax is not None]
            if not dims:
                assert torch.equal(t0, t1), path
            got = torch.cat([t0, t1], dim=dims[0]) if dims else t0
            if key == "new":
                old = dict((p, w) for p, _, w, _ in pairs(res[0]["new"], res[0]["old"], specs))[path]
                got, want = got.float() - old.float(), want.float() - old.float()
            assert rel(got, want) < 5e-2, (key, path, rel(got, want))
