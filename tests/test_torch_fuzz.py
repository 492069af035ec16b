"""Seeded configuration fuzz of the port against JAX's oracle (the twin of
tests/test_fuzz.py).

The same ``random.Random(seed)`` draws as tests/test_fuzz.py:27, :64 and
:101 (tests/torch_fuzz_draws.py: ragged Sq/Skv, GQA groups 1/2/4/5,
windows across block edges, bf16/float32, quantized decode over ragged
lengths) at 12, 6 and 6 seeds, the inputs drawn as that file draws them
(``jax.random`` at the seed's key) and fed as numpy to both sides.  The
forward draw adds K1's modes (segment ids, a block mask, int8 V).  The
port's ``flash_attention``, its backward (``attention_with_vjp``) and
``decode_attention`` run their plain versions here; the oracle is JAX's
``sdpa_reference`` (XLA, no Pallas).  Bars: test_fuzz.py's, RMSE < 1e-2 for
the forward and for int8 and bf16 caches, 4e-2 for int4; the JAX suite's
2e-2 max-relative bar for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fuzz_draws as draws
from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.ops import quant
from quantumattention_tpu_torch.ops.autodiff import attention_with_vjp
from quantumattention_tpu_torch.ops.decode import decode_attention
from quantumattention_tpu_torch.ops.flash import flash_attention

RMSE_TOL = 1e-2
INT4_TOL = 4e-2
GRAD_TOL = 2e-2


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("seed", range(draws.FORWARD_SEEDS))
def test_fuzz_flash_vs_oracle(seed):
    c = draws.forward_case(seed)
    dtype = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[c["dtype"]]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(k1, (1, c["hq"], c["sq"], c["d"]), jnp.float32).astype(dtype)
    k = jax.random.normal(k2, (1, c["hkv"], c["skv"], c["d"]), jnp.float32).astype(dtype)
    v = jax.random.normal(k3, (1, c["hkv"], c["skv"], c["d"]), jnp.float32).astype(dtype)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    kw, ref_kw = {}, {}
    if c["mode"] == "segments":
        ids = [torch.tensor([c[n]], dtype=torch.int32) for n in ("q_segment_ids", "kv_segment_ids")]
        kw = dict(q_segment_ids=ids[0], kv_segment_ids=ids[1])
        ref_kw = {n: jnp.asarray(t.numpy()) for n, t in kw.items()}
    elif c["mode"] == "block_mask":
        bm = np.array(c["block_mask"], bool)
        kw = dict(block_mask=torch.from_numpy(bm))
        full = np.repeat(np.repeat(bm, draws.GRANULE, 0), draws.GRANULE, 1)[: c["sq"], : c["skv"]]
        ref_kw = dict(attn_mask=jnp.asarray(full)[None, None])
    elif c["mode"] == "int8_v":
        tv, scale_v = quant.quantize_channel_wise(tv.float())
        kw = dict(scale_v=scale_v)
        v = jnp.asarray((tv.float() * scale_v[:, :, None, :]).numpy()).astype(dtype)
    out = flash_attention(tq, tk, tv, is_causal=c["is_causal"], window=c["window"], **kw)
    ref = sdpa_reference(q, k, v, is_causal=c["is_causal"], window=draws.oracle_window(c), **ref_kw)
    err = rmse(_f32(out), ref)
    assert err < RMSE_TOL, f"{c}: rmse={err}"


@pytest.mark.parametrize("seed", range(draws.BACKWARD_SEEDS))
def test_fuzz_backward_vs_oracle(seed):
    c = draws.backward_case(seed)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    shapes = [(1, c["hq"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"])]
    q, k, v = (jax.random.normal(key, s, jnp.float32) for key, s in zip((k1, k2, k3), shapes))

    def loss_ref(q, k, v):
        return jnp.sum(sdpa_reference(q, k, v, is_causal=c["is_causal"]).astype(jnp.float32) ** 2)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_torch(a).requires_grad_(True) for a in (q, k, v))
    out = attention_with_vjp(tq, tk, tv, is_causal=c["is_causal"])
    got = torch.autograd.grad((out.float() ** 2).sum(), (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        b = np.asarray(b, np.float64)
        err = np.abs(_f32(a).astype(np.float64) - b).max() / (np.abs(b).max() + 1e-9)
        assert err < GRAD_TOL, f"{c} d{name}: {err}"


@pytest.mark.parametrize("seed", range(draws.DECODE_SEEDS))
def test_fuzz_decode_quantized_vs_oracle(seed):
    c = draws.decode_case(seed)
    b, hq, hkv, smax, d = c["batch"], c["hq"], c["hkv"], c["smax"], c["d"]
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2000 + seed), 3)
    q = jax.random.normal(k1, (b, hq, d), jnp.float32)
    kraw = jax.random.normal(k2, (b, hkv, smax, d), jnp.float32)
    vraw = jax.random.normal(k3, (b, hkv, smax, d), jnp.float32)
    tk, tvv = _torch(kraw), _torch(vraw)
    kw, tol = {}, RMSE_TOL
    if c["container"] == "int8":
        (kc, ks), (vc, vs) = quant.dynamically_quantize_int8(tk), quant.dynamically_quantize_int8(tvv)
        kw = dict(k_scale=ks, v_scale=vs)
    elif c["container"] == "int4":
        (kc, ks), (vc, vs) = quant.dynamically_quantize_int4(tk), quant.dynamically_quantize_int4(tvv)
        kw, tol = dict(k_scale=ks, v_scale=vs), INT4_TOL
    else:
        kc, vc = tk.to(torch.bfloat16), tvv.to(torch.bfloat16)
    lens = torch.tensor(c["lens"], dtype=torch.int32)
    out = decode_attention(_torch(q).to(torch.bfloat16), kc, vc, lens, **kw)

    group = hq // hkv
    outs = []
    for i, n in enumerate(c["lens"]):
        if n == 0:
            outs.append(np.zeros((hq, d), np.float32))
            continue
        o = sdpa_reference(q[i][None, :, None, :], jnp.repeat(kraw[i][None, :, :n], group, axis=1),
                           jnp.repeat(vraw[i][None, :, :n], group, axis=1))
        outs.append(np.asarray(o[0, :, 0, :], np.float32))
    err = rmse(_f32(out), np.stack(outs))
    assert err < tol, f"{c}: rmse={err}"
