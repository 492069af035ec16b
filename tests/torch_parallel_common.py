"""Shared pieces of the parallel layer's CPU parity tests
(tests/test_torch_parallel*.py): the cases' inputs, drawn from numpy with
a seed (the same arrays for the JAX package and the port), and the bars.

Bars, the JAX tests' own: attention RMSE < 1e-3 against JAX's sharded
result and < 1e-2 against the fp32 oracle; the pipeline 2e-5 (rtol and
atol) of the stages applied in sequence, 1e-2 RMSE with an attention
stage; experts rtol 1e-4, atol 1e-5 of the single-device ``moe_ffn``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from quantumattention_tpu.models import moe as jmoe
from quantumattention_tpu.ops.quant import quantize_head_wise

RMSE_TOL = 1e-2
JAX_TOL = 1e-3
SHAPES = {  # case -> (batch, hq, hkv, s, d, seed, dtype)
    "ring_noncausal": (1, 4, 4, 512, 64, 0, "bf16"),
    "ring_causal": (1, 4, 4, 512, 64, 0, "bf16"),
    "ring_gqa_window": (1, 8, 2, 512, 64, 0, "bf16"),
    "ring_local_inputs": (1, 4, 4, 512, 64, 0, "bf16"),
    "head_parallel": (2, 8, 4, 256, 64, 0, "bf16"),
    "head_parallel_fp8": (1, 8, 8, 256, 64, 0, "f32"),
    "head_parallel_indivisible": (1, 8, 2, 256, 64, 0, "bf16"),
    "ulysses": (1, 8, 4, 512, 64, 0, "bf16"),
    "ulysses_indivisible": (1, 6, 2, 256, 64, 0, "bf16"),
    "ring_vs_ulysses": (1, 4, 4, 512, 64, 11, "bf16"),
    "ring_int8_head_wise": (1, 4, 4, 512, 64, 13, "f32"),
    "ring_int8_token_wise": (1, 4, 4, 512, 64, 17, "f32"),
    "ring_bad_scale_rank": (1, 4, 4, 512, 64, 0, "f32"),
    "ring_causal_skip": (1, 2, 2, 1024, 64, 23, "bf16"),
    "ring_multiple_blocks": (1, 2, 2, 1024, 64, 31, "bf16"),
}


def rmse(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def to_torch(a):
    """numpy (ml_dtypes bf16 / e4m3 included) -> torch, bit for bit."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def qkv(name):
    """Numpy q, k, v of a case (bf16 or f32), the same arrays for both sides."""
    b, hq, hkv, s, d, seed, dtype = SHAPES[name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d), dtype=np.float32) for h in (hq, hkv, hkv)]
    if dtype == "bf16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def quantized_case(name, quantize):
    q, k, v = qkv(name)
    q8, sq = quantize(jnp.asarray(q), jnp.int8)
    k8, sk = quantize(jnp.asarray(k), jnp.int8)
    return [np.asarray(a) for a in (q8, k8, v.astype(ml_dtypes.bfloat16), sq, sk)]


def head_fp8_case():
    q, k, v = qkv("head_parallel_fp8")
    q8, sq = quantize_head_wise(jnp.asarray(q))
    k8, sk = quantize_head_wise(jnp.asarray(k))
    return [np.asarray(a) for a in (q8, k8, v.astype(ml_dtypes.bfloat16), sq, sk)]


def pipeline_inputs():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((4, 64, 64), dtype=np.float32) * 0.1,
            "b": rng.standard_normal((4, 64), dtype=np.float32) * 0.1,
            "x": rng.standard_normal((6, 2, 64), dtype=np.float32)}


def pipeline_attention_inputs():
    rng = np.random.default_rng(5)
    return {"wo": rng.standard_normal((2, 128, 128), dtype=np.float32) * 0.05,
            "x": rng.standard_normal((3, 1, 128, 128), dtype=np.float32)}


def moe_inputs(seed, e, h=64, i=128):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), h, i, e, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def expert_inputs(h=64, i=128):
    x = np.random.default_rng(8).standard_normal((8, 16, h), dtype=np.float32)
    return {**moe_inputs(7, 8, h, i), "x": x}


def gathered(res, dim, key="out"):
    return torch.cat([r[key] for r in res], dim=dim).float().numpy()


def check(out, jax_out, ref):
    assert out.shape == np.shape(ref)
    assert not np.isnan(out).any()
    assert rmse(out, jax_out) < JAX_TOL
    assert rmse(out, ref) < RMSE_TOL


def qkv_inputs(name):
    """A case's q, k, v as torch tensors for the ranks."""
    return dict(zip("qkv", map(to_torch, qkv(name))))
