"""Port decode attention and KV cache against the JAX package.

On the CPU the port's ``decode_attention`` runs its plain version and the
JAX side runs its Pallas kernel in interpret mode.  Tolerance: both return
bf16 and round the unnormalized P (times the V scale) to bf16 before P.V;
the JAX kernel's running maximum moves block by block where the plain
version takes one maximum, so they may differ by two bf16 ulps of values
below 1 (ATOL = 1/64).  Empty slots must be exact zeros on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.ops.decode import decode_attention as jdecode
from quantumattention_tpu.serving import kv_cache as jkvc
from quantumattention_tpu_torch.ops import quant
from quantumattention_tpu_torch.ops.decode import decode_attention as tdecode
from quantumattention_tpu_torch.serving import kv_cache as tkvc

ATOL = 1.0 / 64
B, HQ, HKV, SMAX, D = 3, 4, 2, 256, 64
LENGTHS = [0, 37, 200]


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8, torch.float32: jnp.float32}[t.dtype]
    )


def _caches(cache):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, HQ, D)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((B, HKV, SMAX, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, HKV, SMAX, D)).astype(np.float32))
    if cache == "int8":
        kc, ks = quant.dynamically_quantize_int8(k, reduction_dim=-1)
        vc, vs = quant.dynamically_quantize_int8(v, reduction_dim=-1)
        return q, kc, vc, ks, vs
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_decode_matches_jax(cache):
    q, kc, vc, ks, vs = _caches(cache)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    t_out = tdecode(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
    j_out = jdecode(
        _j(q), _j(kc), _j(vc), jnp.asarray(LENGTHS, jnp.int32),
        k_scale=None if ks is None else _j(ks),
        v_scale=None if vs is None else _j(vs),
    )
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert t_out.dtype == torch.bfloat16 and b.shape == (B, HQ, D)
    np.testing.assert_array_equal(b[0], 0.0)
    np.testing.assert_array_equal(a[0], 0.0)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_decode_ignores_rows_past_length():
    q, kc, vc, ks, vs = _caches("int8")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    ref = tdecode(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[1, :, 37:] = 127
    vc2[2, :, 200:] = -128
    out = tdecode(q, kc2, vc2, lengths, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_decode_rejects_what_is_not_ported():
    q, kc, vc, ks, vs = _caches("int8")
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    # The window, refused here before it was ported, now matches JAX's
    # kernel (every cache kind: tests/test_torch_window.py).
    got = tdecode(q, kc, vc, lengths, k_scale=ks, v_scale=vs, window=(16, 0))
    want = jdecode(_j(q), _j(kc), _j(vc), jnp.asarray(LENGTHS, jnp.int32), k_scale=_j(ks),
                   v_scale=_j(vs), window=(16, 0))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[0].float().numpy(), 0.0)
    # The multi-query verify mode is ported (tests/test_torch_verify.py):
    # the 4-D call that used to be refused now runs.
    one = tdecode(q[:, :, None, :], kc, vc, lengths, k_scale=ks, v_scale=vs)
    assert torch.equal(one[:, :, 0], tdecode(q, kc, vc, lengths, k_scale=ks, v_scale=vs))
    with pytest.raises(ValueError, match="requires k_scale"):
        tdecode(q, kc, vc, lengths)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("width", [1, 24])
def test_kv_cache_append_matches_jax(dtype, width):
    """Decode (T = 1) and prompt (T > 1) writes: element-equal containers
    and lengths, scales equal to float32 rounding."""
    tdt, jdt = (torch.int8, jnp.int8) if dtype == "int8" else (torch.bfloat16, jnp.bfloat16)
    rng = np.random.default_rng(width)
    tc = tkvc.init_cache(3, HKV, 64, D, tdt, device="cpu")
    jc = jkvc.init_cache(3, HKV, 64, D, jdt)
    for step in range(2):
        k = rng.standard_normal((2, HKV, width, D)).astype(np.float32)
        v = rng.standard_normal((2, HKV, width, D)).astype(np.float32)
        slots = np.array([2, 0], np.int32)
        offsets = np.array([3 + step * width, step * width], np.int32)
        n_valid = np.array([width, width - 1 if width > 1 else 0], np.int32)
        tkvc.append(
            tc, torch.from_numpy(slots).long(), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(offsets).long(),
            torch.from_numpy(n_valid),
        )
        jc = jkvc.append(
            jc, jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(offsets), jnp.asarray(n_valid),
        )
    np.testing.assert_array_equal(tc.k.float().numpy(), np.asarray(jc.k.astype(jnp.float32)))
    np.testing.assert_array_equal(tc.v.float().numpy(), np.asarray(jc.v.astype(jnp.float32)))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if dtype == "int8":
        # Under jit XLA turns amax / 127 into amax * (1 / 127): one float32
        # ulp apart from the eager division (2.4e-7 is two ulps).
        np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=2.4e-7, atol=0)
        np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=2.4e-7, atol=0)
    else:
        assert tc.k_scale is None and jc.k_scale is None
    tkvc.free_slots(tc, torch.tensor([2]))
    assert tc.lengths.tolist()[2] == 0
