"""Port K1 residuals and the blockwise backward (K2/K3) against the JAX package.

On the CPU the port's wrappers run their plain versions (fp32 over whole
(Sq, Skv) matrices); the JAX side runs its Pallas kernels in interpret
mode, as the JAX suite does.  Inputs are bf16, made from numpy seeds.

Tolerances:
  * residuals: the JAX kernel pre-scales q by sm_scale * log2 e in bf16
    (one bf16 rounding of every score, ~2^-9 relative) where the port keeps
    fp32, so m may differ by 2^-7 of its magnitude plus 1/64, and l by 2%;
  * gradients: max|a - b| / max|b| < 2e-2, the JAX suite's bar
    (tests/test_autodiff.py:27-30), on the same (q, k, v, o, dO, m, l).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.ops.flash import flash_attention as jflash
from quantumattention_tpu.ops.flash_bwd import flash_attention_bwd as jbwd
from quantumattention_tpu_torch.ops import flash_bwd as tfb
from quantumattention_tpu_torch.ops.flash import flash_attention as tflash

GRAD_BAR = 2e-2


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _pair(rng, shape):
    """One bf16 tensor for each framework, from a numpy draw."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _problem(seed, hq, hkv, s, causal, d=64):
    """(torch, jax) inputs plus the JAX forward's (o, m, l) and a dO."""
    rng = np.random.default_rng(seed)
    (tq, jq), (tk, jk), (tv, jv) = (_pair(rng, (1, h, s, d)) for h in (hq, hkv, hkv))
    jo, (jm, jl) = jflash(jq, jk, jv, is_causal=causal, return_residuals=True)
    tdo, jdo = _pair(rng, (1, hq, s, d))
    to = torch.from_numpy(np.array(_f32(jo))).to(torch.bfloat16)
    tm = torch.from_numpy(np.array(jm[..., 0]))
    tl = torch.from_numpy(np.array(jl[..., 0]))
    return (tq, tk, tv, to, tdo, tm, tl), (jq, jk, jv, jo, jdo, jm, jl)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 128), (8, 2, 250)])
def test_residuals_match_jax(hq, hkv, s, causal):
    (tq, tk, tv, *_), (jq, jk, jv, *_) = _problem(s + hq, hq, hkv, s, causal)
    jo, (jm, jl) = jflash(jq, jk, jv, is_causal=causal, return_residuals=True)
    to, (tm, tl) = tflash(tq, tk, tv, is_causal=causal, return_residuals=True)
    assert tm.shape == tl.shape == (1, hq, s) and tm.dtype == torch.float32
    jm0, jl0 = np.asarray(jm[..., 0]), np.asarray(jl[..., 0])
    np.testing.assert_allclose(tm.numpy(), jm0, rtol=2**-7, atol=1 / 64)
    np.testing.assert_allclose(tl.numpy(), jl0, rtol=2e-2)
    # The residuals reproduce the softmax: sum_j exp2(s_j - m) == l.
    assert (tl.numpy() >= 1.0 - 1e-5).all()
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1 / 16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 128), (4, 4, 250), (8, 2, 128), (8, 2, 250)])
def test_bwd_matches_jax(hq, hkv, s, causal):
    targs, jargs = _problem(3 * s + hq, hq, hkv, s, causal)
    jgrads = jbwd(*jargs, is_causal=causal)
    tgrads = tfb.flash_attention_bwd(*targs, is_causal=causal)
    for tg, jg, t, name in zip(tgrads, jgrads, targs[:3], "qkv"):
        assert tg.shape == t.shape and tg.dtype == t.dtype, name
        assert rel_err(_f32(tg), _f32(jg)) < GRAD_BAR, f"d{name}"


def test_bwd_plain_parts_agree_with_whole():
    """The kernels' plain versions (what the CPU runs) compose to the plain
    backward, and GQA's dK/dV are the per-q-head sums."""
    targs, _ = _problem(5, 8, 2, 96, True)
    q, k, v, o, do, m, l = targs
    whole = tfb.flash_attention_bwd_plain(*targs, is_causal=True)
    delta = tfb.row_delta(o, do)
    dq = tfb.flash_bwd_dq(q, k, v, do, m, l, delta, is_causal=True)
    dk, dv = tfb.flash_bwd_dkv(q, k, v, do, m, l, delta, is_causal=True)
    for a, b in zip((dq, dk, dv), whole):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    rep = [t.repeat_interleave(4, dim=1) for t in (k, v)]
    dk4, dv4 = tfb.flash_bwd_dkv(q, *rep, do, m, l, delta, is_causal=True)
    torch.testing.assert_close(dk4.float().reshape(1, 2, 4, 96, 64).sum(2), dk.float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(dv4.float().reshape(1, 2, 4, 96, 64).sum(2), dv.float(),
                               atol=2e-2, rtol=2e-2)


def test_bwd_refuses_what_is_not_ported():
    """Mismatched residuals raise.  A window, refused here before it was
    ported, now gives JAX's gradients (on the forward's residuals without
    the window, the backward's own mask is what is compared)."""
    targs, jargs = _problem(6, 2, 2, 64, True)
    jgrads = jbwd(*jargs, is_causal=True, window=(16, 0))
    tgrads = tfb.flash_attention_bwd(*targs, is_causal=True, window=(16, 0))
    for tg, jg, name in zip(tgrads, jgrads, "qkv"):
        assert rel_err(_f32(tg), _f32(jg)) < GRAD_BAR, f"d{name}"
    q, k, v, o, do, m, l = targs
    with pytest.raises(ValueError, match="m and l"):
        tfb.flash_attention_bwd(q, k, v, o, do, m[..., :-1], l, is_causal=True)
