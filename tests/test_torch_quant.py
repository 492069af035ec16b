"""Port quantizers against the JAX package's: element-equal values and scales.

The same numpy inputs go through ``quantumattention_tpu.ops.quant`` and
``quantumattention_tpu_torch.ops.quant``; the math is identical (amax/qmax,
eps floor, clamp before the cast, int8 rounds half-to-even), so the
tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.ops import quant as jq
from quantumattention_tpu_torch.ops import quant as tq


def _inputs(seed, shape=(2, 3, 37, 64)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[0, 0, 0, :4] = [0.0, 1e-30, -1e-30, 0.0]  # scales clamp to eps
    x[1, 2] = 0.0  # an all-zero head
    return x


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("granularity", ["head", "token"])
@pytest.mark.parametrize("container", ["fp8", "int8"])
def test_quantize_matches_jax(granularity, container):
    x = _inputs(1)
    jfn = jq.quantize_head_wise if granularity == "head" else jq.quantize_token_wise
    tfn = tq.quantize_head_wise if granularity == "head" else tq.quantize_token_wise
    jdt = jnp.float8_e4m3fn if container == "fp8" else jnp.int8
    tdt = torch.float8_e4m3fn if container == "fp8" else torch.int8
    jv, js = jfn(jnp.asarray(x).astype(jnp.bfloat16), jdt)
    tv, ts = tfn(torch.from_numpy(x).to(torch.bfloat16), tdt)
    assert tv.dtype == tdt and ts.dtype == torch.float32
    assert tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("fn", ["dynamically_quantize_fp8", "dynamically_quantize_int8"])
@pytest.mark.parametrize("reduction_dim", [-1, (-2, -1), 1])
def test_dynamic_quantize_matches_jax(fn, reduction_dim):
    x = _inputs(2, (3, 4, 5, 32))
    jv, js = getattr(jq, fn)(jnp.asarray(x), reduction_dim=reduction_dim)
    tv, ts = getattr(tq, fn)(torch.from_numpy(x), reduction_dim=reduction_dim)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequantize_roundtrip():
    x = torch.from_numpy(_inputs(3))
    v, s = tq.quantize_token_wise(x, torch.int8)
    back = tq.dequantize(v, s)
    # int8 rounding: at most half a quantization step per element.
    assert bool(((back - x).abs() <= s[..., None] * 0.5 + 1e-6).all())
