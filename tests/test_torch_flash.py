"""Port flash attention, entry points and validation against the JAX package.

On the CPU the port's ``flash_attention`` runs its plain version (fp32
attention over the dequantized inputs), and the JAX side runs its Pallas
kernel in interpret mode, as the JAX suite does.  Tolerance: both outputs
are bf16; the JAX kernel rounds P to bf16 and pre-scales q in bf16 where
the plain version keeps fp32, so they may differ by a couple of bf16 ulps
of values below 4 (ATOL = 1/16), and the RMSE between them must stay under
a fifth of the repository's 1e-2 bar against the fp32 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu import config as jconfig
from quantumattention_tpu import dispatch as jdispatch
from quantumattention_tpu.ops import quant as jq
from quantumattention_tpu.ops.flash import flash_attention as jflash
import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import config as tconfig
from quantumattention_tpu_torch import dispatch as tdispatch
from quantumattention_tpu_torch.ops import quant as tq
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash

ATOL = 1.0 / 16
RMSE_MAX = 2e-3


def _qkv(seed, s, b=1, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)
    ]
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jj = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tt]
    return tt, jj


def _close(j_out, t_out):
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
    assert np.sqrt(np.mean((a - b) ** 2)) < RMSE_MAX


@pytest.mark.parametrize("seq", [64, 200])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "head", "token"])
def test_flash_matches_jax(mode, causal, seq):
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(seq, seq)
    if mode == "bf16":
        j_out = jflash(jq_, jk, jv, is_causal=causal)
        t_out = tflash(tq_, tk, tv, is_causal=causal)
    else:
        jfn = jq.quantize_head_wise if mode == "head" else jq.quantize_token_wise
        tfn = tq.quantize_head_wise if mode == "head" else tq.quantize_token_wise
        jq8, jsq = jfn(jq_)
        jk8, jsk = jfn(jk)
        tq8, tsq = tfn(tq_)
        tk8, tsk = tfn(tk)
        j_out = jflash(jq8, jk8, jv, scale_q=jsq, scale_k=jsk, is_causal=causal)
        t_out = tflash(tq8, tk8, tv, scale_q=tsq, scale_k=tsk, is_causal=causal)
    assert t_out.dtype == torch.bfloat16
    _close(j_out, t_out)


def test_flash_ragged_and_mixed_lengths():
    """Sq != Skv (ragged on both sides), top-left causal, like the JAX kernel."""
    rng = np.random.default_rng(7)
    shapes = [(1, 4, 45, 64), (1, 2, 77, 64), (1, 2, 77, 64)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jj = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tt]
    _close(jflash(*jj, is_causal=True), tflash(*tt, is_causal=True))


ENTRY_POINTS = [
    "attn_func",
    "attn_func_with_fallback",
    "fp8_attn_func",
    "fp8_attn_func_with_fallback",
    "fp8_token_wise_attn_func",
    "fp8_token_wise_attn_func_with_fallback",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_match_jax(name):
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(11, 96)
    j_out = getattr(qj, name)(jq_, jk, jv, is_causal=True)
    t_out = getattr(qt, name)(tq_, tk, tv, is_causal=True)
    _close(j_out, t_out)


def test_prequantized_entry_point_and_dynamic_quantizer():
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(12, 80)
    tq8, tsq = qt.dynamically_quantize_fp8(tq_, reduction_dim=(-2, -1))
    tk8, tsk = qt.dynamically_quantize_fp8(tk, reduction_dim=(-2, -1))
    jq8, jsq = qj.dynamically_quantize_fp8(jq_, reduction_dim=(-2, -1))
    jk8, jsk = qj.dynamically_quantize_fp8(jk, reduction_dim=(-2, -1))
    j_out = qj.fp8_attn_func(jq8, jk8, jv, scale_q=jsq, scale_k=jsk)
    t_out = qt.fp8_attn_func(tq8, tk8, tv, scale_q=tsq, scale_k=tsk)
    _close(j_out, t_out)


def _reason_cases():
    """Input specs the fused kernel refuses, by name."""
    def z(shape, dt="bf16"):
        return shape, dt

    base = dict(q=z((1, 4, 8, 64)), k=z((1, 2, 8, 64)), v=z((1, 2, 8, 64)))
    cases = {
        "attn_mask": dict(base, attn_mask=z((8, 8), "bool")),
        "dropout": dict(base, dropout_p=0.1),
        "rank": dict(base, q=z((4, 8, 64))),
        "batch": dict(base, k=z((2, 2, 8, 64)), v=z((2, 2, 8, 64))),
        "kv_heads": dict(base, v=z((1, 4, 8, 64))),
        "gqa": dict(base, k=z((1, 3, 8, 64)), v=z((1, 3, 8, 64))),
        "kv_len": dict(base, v=z((1, 2, 9, 64))),
        "qk_dim": dict(base, k=z((1, 2, 8, 32)), v=z((1, 2, 8, 32))),
        "v_dim": dict(base, v=z((1, 2, 8, 32))),
        "int8_no_scales": dict(base, q=z((1, 4, 8, 64), "int8"), k=z((1, 2, 8, 64), "int8")),
        "scale_pair": dict(base, scale_q=z((1, 4), "f32")),
        "scale_rank": dict(base, scale_q=z((1,), "f32"), scale_k=z((1,), "f32")),
        "scale_rank_mismatch": dict(base, scale_q=z((1, 4), "f32"), scale_k=z((1, 2, 8), "f32")),
        "scaling_method": dict(
            base, scale_q=z((1, 4), "f32"), scale_k=z((1, 2), "f32"),
            scaling_method="token-wise",
        ),
        "scale_q_lead": dict(base, scale_q=z((1, 3), "f32"), scale_k=z((1, 2), "f32")),
        "scale_k_lead": dict(base, scale_q=z((1, 4), "f32"), scale_k=z((1, 4), "f32")),
        "token_len": dict(base, scale_q=z((1, 4, 7), "f32"), scale_k=z((1, 2, 8), "f32")),
    }
    return cases


_JDT = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32, "bool": jnp.bool_}
_TDT = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32, "bool": torch.bool}


def _build(spec, zeros, dtypes):
    args = {}
    for key, val in spec.items():
        if isinstance(val, tuple):
            shape, dt = val
            args[key] = zeros(shape, dtype=dtypes[dt])
        else:
            args[key] = val
    q, k, v = args.pop("q"), args.pop("k"), args.pop("v")
    pos = (args.pop("attn_mask", None), args.pop("dropout_p", 0.0))
    return (q, k, v) + pos, args


@pytest.mark.parametrize("case", sorted(_reason_cases()))
def test_reason_strings_match_jax(case):
    spec = _reason_cases()[case]
    jargs, jkw = _build(spec, jnp.zeros, _JDT)
    targs, tkw = _build(spec, torch.zeros, _TDT)
    j_ok, j_reason = jdispatch.validate_flash_input(*jargs, **jkw)
    t_ok, t_reason = tdispatch.validate_flash_input(*targs, **tkw)
    assert not j_ok and not t_ok
    assert t_reason == j_reason.replace("jnp.", "")
    assert qt.can_use_attention(*targs, **tkw) == (False, f"[cuda: {t_reason}]")


def test_port_only_refusals():
    """No refusal is the port's own any more: head dims other than
    64/128/256 that JAX takes (multiples of 8 up to 512) are taken by the
    port too, and the fused path serves them without the fallback; D = 520
    gets JAX's message word for word.  fp32 Q/K/V are taken by both."""
    q = torch.zeros((1, 4, 8, 96), dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16)
    assert qt.can_use_attention(q, kv, kv) == (True, "")
    jz = [jnp.zeros(t.shape, jnp.bfloat16) for t in (q, kv, kv)]
    assert jdispatch.validate_flash_input(*jz) == (True, "")
    wide = [jnp.zeros(t.shape[:3] + (520,), jnp.bfloat16) for t in (q, kv, kv)]
    j_ok, j_reason = jdispatch.validate_flash_input(*wide)
    t_ok, t_reason = tdispatch.validate_flash_input(
        *(torch.zeros(t.shape[:3] + (520,), dtype=torch.bfloat16) for t in (q, kv, kv)))
    assert not j_ok and not t_ok
    assert t_reason == j_reason == "head_dim 520 unsupported (want one of (64, 128, 256) or a multiple of 8 <= 512)"
    before = tdispatch.sdpa_fallback.calls
    out = qt.attn_func_with_fallback(q, kv, kv)
    assert out.shape == q.shape and tdispatch.sdpa_fallback.calls == before
    f = torch.zeros((1, 4, 8, 64), dtype=torch.float32)
    assert qt.can_use_attention(f, f[:, :2], f[:, :2]) == (True, "")


def test_config_gates_and_fallback_counter():
    (tq_, tk, tv), _ = _qkv(3, 16)
    with tconfig.patch({"attention.force_fallback": True}):
        assert qt.can_use_attention(tq_, tk, tv) == (
            False, "[cuda: disabled by config.attention.force_fallback]"
        )
        before = tdispatch.sdpa_fallback.calls
        qt.fp8_attn_func_with_fallback(tq_, tk, tv)
        assert tdispatch.sdpa_fallback.calls == before + 1
        with pytest.raises(ValueError, match="force_fallback"):
            qt.attn_func(tq_, tk, tv)
    with tconfig.patch({"attention.enable_cuda_kernel": False}):
        assert not qt.can_use_attention(tq_, tk, tv)[0]
    assert tconfig.get("attention.force_fallback") is False
    with tconfig.patch(**{"attention.skip_supported_check": True}):
        assert qt.can_use_attention(tq_, tk[:, :, :3], tv) == (True, "")
    with pytest.raises(AttributeError):
        tconfig.get("attention.vmem_limit_mb")


def test_not_yet_ported_raise():
    """Per-block scaling, windows and ``kv_offset``, each refused here
    before it was ported, now run and match the JAX package (more cases in
    tests/test_torch_block_quant.py and tests/test_torch_window.py).  JAX's
    per-block runs its e4m3 container (``attention.fp8_dot``), the port's
    only one."""
    (tq_, tk, tv), (jq_, jk, jv) = _qkv(4, 16)
    with jconfig.patch({"interpret": True, "attention.fp8_dot": True}):
        _close(qj.fp8_attn_func(jq_, jk, jv, is_causal=True, scaling_method="per-block"),
               qt.fp8_attn_func(tq_, tk, tv, is_causal=True, scaling_method="per-block"))
    with jconfig.patch({"interpret": True}):
        _close(qj.attn_func(jq_, jk, jv, window=(8, 0)), qt.attn_func(tq_, tk, tv, window=(8, 0)))
    _close(jflash(jq_, jk, jv, is_causal=True, q_offset=jnp.int32(5), kv_offset=jnp.int32(3),
                  interpret=True),
           tflash(tq_, tk, tv, is_causal=True, q_offset=5, kv_offset=3))
