"""Port autograd Functions against the JAX package's custom VJPs
(mirrors tests/test_autodiff.py).

On the CPU the port's kernels run their plain versions, so the Functions'
forward is the fp32 oracle and their backward the plain K2/K3; the JAX side
runs its Pallas kernels in interpret mode.  Inputs are bf16 from numpy
seeds; the loss is sum(out**2), as in the JAX suite.

Tolerances, max|a - b| / max|b|: 2e-2 for exact-attention gradients (the
JAX suite's bar, tests/test_autodiff.py:27-30); 1e-1 for the fp8 path,
whose straight-through gradient is taken at the fp8 forward's output
(tests/test_autodiff.py:182).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumattention_tpu as qj
from quantumattention_tpu import config as jconfig
import quantumattention_tpu_torch as qt
from quantumattention_tpu.ops.autodiff import attention_with_vjp as j_vjp
from quantumattention_tpu.ops.quant import quantize_head_wise as jquant
from quantumattention_tpu_torch import config as tconfig
from quantumattention_tpu_torch import dispatch as tdispatch
from quantumattention_tpu_torch.ops import autodiff as tad
from quantumattention_tpu_torch.ops.quant import quantize_head_wise as tquant

EXACT_BAR = 2e-2
STE_BAR = 1e-1


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _qkv(seed, hq, hkv, s, d=64):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    tt = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrs]
    jj = [jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16) for t in tt]
    return tt, jj


def _torch_grads(fn, tt):
    out = fn(*tt)
    return torch.autograd.grad((out.float() ** 2).sum(), tt)


def _jax_grads(fn, jj):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2),
                    argnums=(0, 1, 2))(*jj)


def _assert_grads(tg, jg, bar):
    for a, b, name in zip(tg, jg, "qkv"):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        assert rel_err(_f32(a), _f32(b)) < bar, f"d{name}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 128), (8, 2, 200)])
def test_attention_with_vjp_grads_match_jax(hq, hkv, s, causal):
    tt, jj = _qkv(s + hq, hq, hkv, s)
    tg = _torch_grads(lambda q, k, v: tad.attention_with_vjp(q, k, v, is_causal=causal), tt)
    jg = _jax_grads(lambda q, k, v: j_vjp(q, k, v, is_causal=causal), jj)
    _assert_grads(tg, jg, EXACT_BAR)


@pytest.mark.parametrize("causal", [False, True])
def test_cuda_bwd_flag_matches_oracle_vjp(causal):
    """kernel.cuda_bwd=True (K1 residuals + K2/K3) against False (autograd
    through the fp32 oracle): both are the gradient of exact attention."""
    tt, _ = _qkv(7, 8, 2, 160)
    fn = lambda q, k, v: qt.attn_func(q, k, v, is_causal=causal)  # noqa: E731
    with tconfig.patch({"kernel.cuda_bwd": True}):
        g_kernel = _torch_grads(fn, tt)
    with tconfig.patch({"kernel.cuda_bwd": False}):
        g_oracle = _torch_grads(fn, tt)
    _assert_grads(g_kernel, g_oracle, EXACT_BAR)


@pytest.mark.parametrize("scaling_method", ["head-wise", "token-wise", "per-block"])
def test_fp8_ste_grads_match_jax(scaling_method):
    """JAX's per-block runs its e4m3 container (``attention.fp8_dot``), the
    port's only one."""
    tt, jj = _qkv(11, 4, 2, 128)
    tg = _torch_grads(
        lambda q, k, v: qt.fp8_attn_func(q, k, v, is_causal=True, scaling_method=scaling_method),
        tt,
    )
    with jconfig.patch({"attention.fp8_dot": True} if scaling_method == "per-block" else {}):
        jg = _jax_grads(
            lambda q, k, v: qj.fp8_attn_func(q, k, v, is_causal=True,
                                             scaling_method=scaling_method),
            jj,
        )
    _assert_grads(tg, jg, STE_BAR)


def test_fp8_ste_backward_is_exact_attention_gradient():
    """Given the same output gradient, the STE backward equals the exact
    bf16 attention backward, through K2/K3 and through the oracle alike."""
    tt, _ = _qkv(12, 8, 2, 96)
    g_out = torch.randn(1, 8, 96, 64, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = qt.fp8_attn_func(*tt, is_causal=True)
    g_fp8 = torch.autograd.grad(out, tt, g_out)
    out = qt.attn_func(*tt, is_causal=True)
    g_exact = torch.autograd.grad(out, tt, g_out)
    for a, b in zip(g_fp8, g_exact):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with tconfig.patch({"kernel.cuda_bwd": False}):
        out = qt.fp8_attn_func(*tt, is_causal=True)
        g_oracle = torch.autograd.grad(out, tt, g_out)
    _assert_grads(g_fp8, g_oracle, EXACT_BAR)


def test_quantize_ste_matches_jax():
    from quantumattention_tpu.ops.autodiff import quantize_ste as j_ste

    x = np.random.default_rng(3).standard_normal((2, 4, 64, 64)).astype(np.float32)

    def j_loss(x):
        xq, scale = j_ste(jquant, x)
        return jnp.sum(xq.astype(jnp.float32) * scale[..., None, None])

    tx = torch.from_numpy(x).requires_grad_()
    xq, scale = tad.quantize_ste(tquant, tx)
    assert xq.dtype == torch.float8_e4m3fn and not scale.requires_grad
    (g,) = torch.autograd.grad((xq.float() * scale[..., None, None]).sum(), tx)
    jg = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    assert g.shape == tx.shape and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=0)


ENTRY_POINTS = {
    "attn_func": (qt.attn_func, "FlashAttention"),
    "attn_func_with_fallback": (qt.attn_func_with_fallback, "FlashAttention"),
    "fp8_attn_func": (qt.fp8_attn_func, "_Fp8Attention"),
    "fp8_attn_func_with_fallback": (qt.fp8_attn_func_with_fallback, "_Fp8Attention"),
    "fp8_token_wise_attn_func": (qt.fp8_token_wise_attn_func, "_Fp8Attention"),
    "fp8_token_wise_attn_func_with_fallback": (
        qt.fp8_token_wise_attn_func_with_fallback, "_Fp8Attention"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_record_the_port_function(name):
    """Every entry point's float path records the port's own Function, so
    the CPU and the card take the same autograd path (on the card the
    kernel's output has no autograd history of its own)."""
    fn, function = ENTRY_POINTS[name]
    tt, _ = _qkv(13, 4, 2, 64)
    out = fn(*tt, is_causal=True)
    assert type(out.grad_fn).__name__ == f"{function}Backward"
    grads = torch.autograd.grad(out.float().sum(), tt)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    with torch.no_grad():
        assert fn(*tt, is_causal=True).grad_fn is None


def test_prequantized_inputs_stay_forward_only():
    tt, _ = _qkv(14, 4, 2, 64)
    q8, sq = tquant(tt[0].detach())
    k8, sk = tquant(tt[1].detach())
    out = qt.fp8_attn_func(q8, k8, tt[2].detach(), scale_q=sq, scale_k=sk, is_causal=True)
    assert out.grad_fn is None
    out = tdispatch.attention(q8, k8, tt[2].detach(), scale=None)
    assert out.grad_fn is None
