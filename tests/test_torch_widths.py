"""Head dim 256 and fp32 inputs through the port, against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode (the paged kernel through its DMA path,
``use_dma=True``), as the JAX suite does.  Inputs are made from numpy seeds
at small sizes (S <= 64, few heads: interpret mode is slow at D = 256).

Tolerances:
  * forward (bf16 or fp32 outputs): the JAX kernel rounds P to bf16 and
    pre-scales q in bf16 where the plain version keeps fp32, so outputs may
    differ by a couple of bf16 ulps of values below 4 (ATOL = 1/16), with
    an RMSE under a fifth of the repository's 1e-2 bar (RMSE_MAX = 2e-3),
    as tests/test_torch_flash.py holds them.  fp32 inputs take the same
    bar: the JAX kernel runs fp32 operands through its products
    (ops/flash.py:109-120) but still exponentiates in bf16, the plain
    version stays in fp32; on the card K1 rounds fp32 Q/K/V to bf16 and is
    held to the 1e-2 RMSE bar against the fp32 oracle (chip_smoke.py);
  * gradients: max|a - b| / max|b| < 2e-2, the JAX suite's bar
    (tests/test_autodiff.py:27-30);
  * paged decode: RMSE < 1e-2 and max |diff| <= 1/32, as
    tests/test_torch_paged.py holds K10's plain version to JAX's kernel.
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
from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import dispatch as tdispatch
from quantumattention_tpu_torch.ops import flash_bwd as tfb
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash
from quantumattention_tpu_torch.ops.paged import paged_decode_attention
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference

ATOL = 1.0 / 16
RMSE_MAX = 2e-3
GRAD_BAR = 2e-2
PAGED_ATOL = 1.0 / 32
PAGED_RMSE = 1e-2
D = 256


def _qkv(seed, s, dtype, hq=4, hkv=2, d=D):
    """The same (q, k, v) values for each framework, in `dtype` ("bf16"/"fp32")."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    if dtype == "bf16":
        tt = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
        jj = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tt]
    else:
        tt = [torch.from_numpy(a) for a in arrs]
        jj = [jnp.asarray(a) for a in arrs]
    return tt, jj


def _close(j_out, t_out):
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    assert np.sqrt(np.mean((a - b) ** 2)) < RMSE_MAX


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "head", "token"])
def test_flash_d256_matches_jax(mode, causal):
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(40, 64, "bf16")
    if mode == "bf16":
        j_out = jflash(jq_, jk, jv, is_causal=causal)
        t_out = tflash(tq_, tk, tv, is_causal=causal)
    else:
        jfn = jq.quantize_head_wise if mode == "head" else jq.quantize_token_wise
        tfn = tq.quantize_head_wise if mode == "head" else tq.quantize_token_wise
        (jq8, jsq), (jk8, jsk) = jfn(jq_), jfn(jk)
        (tq8, tsq), (tk8, tsk) = tfn(tq_), tfn(tk)
        j_out = jflash(jq8, jk8, jv, scale_q=jsq, scale_k=jsk, is_causal=causal)
        t_out = tflash(tq8, tk8, tv, scale_q=tsq, scale_k=tsk, is_causal=causal)
    assert t_out.dtype == torch.bfloat16 and t_out.shape == (1, 4, 64, D)
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
def test_entry_points_d256_match_jax(name):
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(41, 48, "bf16")
    before = tdispatch.sdpa_fallback.calls
    _close(getattr(qj, name)(jq_, jk, jv, is_causal=True),
           getattr(qt, name)(tq_, tk, tv, is_causal=True))
    assert tdispatch.sdpa_fallback.calls == before  # the fused path took it


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_fp32_match_jax(name):
    """fp32 Q/K/V in, fp32 out (v's dtype, as in JAX), through the fused
    path on both sides."""
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(42, 64, "fp32", d=128)
    before = tdispatch.sdpa_fallback.calls
    j_out = getattr(qj, name)(jq_, jk, jv, is_causal=True)
    t_out = getattr(qt, name)(tq_, tk, tv, is_causal=True)
    assert t_out.dtype == torch.float32 and j_out.dtype == jnp.float32
    assert tdispatch.sdpa_fallback.calls == before
    _close(j_out, t_out)


@pytest.mark.parametrize("entry", ["attn_func", "fp8_attn_func"])
def test_fp32_gradients_are_fp32(entry):
    """Gradients of fp32 inputs come back in fp32 and equal the fp32
    oracle's autograd (the float path of fp8_attn_func is straight-through:
    exact attention's gradient at the float inputs)."""
    (tq_, tk, tv), _ = _qkv(43, 40, "fp32", d=128)
    leaves = [t.clone().requires_grad_() for t in (tq_, tk, tv)]
    out = getattr(qt, entry)(*leaves, is_causal=True)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_() for t in (tq_, tk, tv)]
    ref = sdpa_reference(*ref_leaves, is_causal=True, out_dtype=torch.float32)
    ref_out = (out if entry == "fp8_attn_func" else ref).detach()
    ref_grads = torch.autograd.grad(ref, ref_leaves, 2 * ref_out)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.float32
        assert float((g - r).abs().max() / r.abs().max()) < GRAD_BAR


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_d256_matches_jax(causal):
    """K2/K3's plain versions against JAX's blockwise backward at D = 256,
    GQA, on the JAX forward's (o, m, l)."""
    rng = np.random.default_rng(44 + causal)

    def pair(shape):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    (tq_, jq_), (tk, jk), (tv, jv), (tdo, jdo) = (
        pair((1, h, 48, D)) for h in (4, 2, 2, 4))
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
def test_paged_d256_matches_jax_dma_kernel(kind):
    b, hkv, group, ps, pps = 2, 1, 4, 32, 2
    rng = np.random.default_rng(45)
    num_pages = b * pps + 1
    kf = rng.standard_normal((hkv, num_pages, ps, D)).astype(np.float32)
    vf = rng.standard_normal((hkv, num_pages, ps, D)).astype(np.float32)
    table = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((b, hkv * group, D)).astype(np.float32))
    q = q.to(torch.bfloat16)
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
    lengths = np.asarray([pps * ps - 5, 0], np.int32)
    got = paged_decode_attention(q, pages[0], pages[1], torch.from_numpy(lengths),
                                 torch.from_numpy(table), k_scale_pages=pages[2],
                                 v_scale_pages=pages[3], pages_per_block=1)
    jqv = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    want = jpaged(jqv, jpages[0], jpages[1], jnp.asarray(lengths), jnp.asarray(table),
                  k_scale_pages=jpages[2], v_scale_pages=jpages[3], pages_per_block=1,
                  use_dma=True, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv * group, D)
    assert torch.equal(got[1], torch.zeros_like(got[1]))  # the empty slot
    diff = got.float() - want
    assert float(diff.abs().max()) <= PAGED_ATOL
    assert float(diff.pow(2).mean().sqrt()) < PAGED_RMSE


@pytest.mark.parametrize("case", ["d256", "fp32", "fp32_fp8_v", "d256_token_scales"])
def test_validation_accepts_like_jax(case):
    """D = 256 and fp32 Q/K/V: both packages answer (True, "")."""
    d, dt = (128, "f32") if case.startswith("fp32") else (D, "bf16")
    shapes = {"q": (1, 4, 8, d), "k": (1, 2, 8, d), "v": (1, 2, 8, d)}
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}
    jargs = [jnp.zeros(shapes[n], jdt[dt]) for n in "qkv"]
    targs = [torch.zeros(shapes[n], dtype=tdt[dt]) for n in "qkv"]
    jkw, tkw = {}, {}
    if case == "fp32_fp8_v":
        jargs[2] = jargs[2].astype(jnp.float8_e4m3fn)
        targs[2] = targs[2].to(torch.float8_e4m3fn)
    if case == "d256_token_scales":
        jkw = {"scale_q": jnp.ones((1, 4, 8)), "scale_k": jnp.ones((1, 2, 8))}
        tkw = {"scale_q": torch.ones((1, 4, 8)), "scale_k": torch.ones((1, 2, 8))}
    assert jdispatch.validate_flash_input(*jargs, **jkw) == (True, "")
    assert tdispatch.validate_flash_input(*targs, **tkw) == (True, "")
    assert qt.can_use_attention(*targs, **tkw) == (True, "")
