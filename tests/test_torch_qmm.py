"""K5/K6/K7's plain versions (ops/qmm.py) against the JAX package's Pallas
kernels in interpret mode, at the JAX suite's shapes (tests/test_qmm.py,
tests/test_int4_weights.py), plus the gates and the routing of
``models/quantized.matmul``.

Both sides get the same inputs (numpy from a seed; weights quantized by
the JAX package and carried across bit for bit).  Tolerances, as
RMSE / std of the JAX result: bf16 outputs 5e-3 (the JAX suite's bar: both
sum in fp32 and round once to bf16, in other orders, so single-ulp flips
remain); fp32 outputs 1e-5 (the same fp32 products summed in another
order: ~1e-7 expected).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu.ops import qmm as jqmm
from quantumattention_tpu_torch import config
from quantumattention_tpu_torch.models import quantized as tq
from quantumattention_tpu_torch.ops import qmm

BAR = {"bfloat16": 5e-3, "float32": 1e-5}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _inputs(m, k, n, dtype, seed, int4=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    wq = (jq.quantize_matrix_int4 if int4 else jq.quantize_matrix)(jnp.asarray(w))
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt), wq, {k_: _t(v) for k_, v in wq.items()}


def _rel(got, want):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.sqrt(np.mean((g - w) ** 2)) / (np.std(w) + 1e-9))


@pytest.mark.parametrize("n_streams", [None, 2], ids=["k5", "k6"])
@pytest.mark.parametrize(
    "m,k,n,dtype",
    [(16, 512, 512, "bfloat16"), (33, 256, 384, "float32"),
     (128, 1024, 256, "bfloat16"), (8, 128, 128, "float32")],
)
def test_qmm_plain_matches_jax_kernel(m, k, n, dtype, n_streams):
    jx, tx, jw, tw = _inputs(m, k, n, dtype, seed=m + k)
    want = jqmm.quantized_matmul(jx, jw["q"], jw["s"], n_streams=n_streams, interpret=True)
    got = qmm.quantized_matmul(tx, tw["q"], tw["s"], n_streams=n_streams)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    assert _rel(got, want) < BAR[dtype]


@pytest.mark.parametrize("m,k,n,dtype", [(16, 512, 384, "float32"), (33, 1024, 512, "bfloat16")])
def test_qmm4_plain_matches_jax_kernel(m, k, n, dtype):
    jx, tx, jw, tw = _inputs(m, k, n, dtype, seed=k, int4=True)
    want = jqmm.quantized_matmul4(jx, jw["q4"], jw["s"], interpret=True)
    got = qmm.quantized_matmul4(tx, tw["q4"], tw["s"])
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    assert _rel(got, want) < BAR[dtype]


def test_qmm_gates_and_errors():
    x = torch.zeros((4, 512), dtype=torch.bfloat16)
    w = torch.zeros((512, 512), dtype=torch.int8)
    assert qmm.supported(x, w)
    assert not qmm.supported(x, w.bfloat16())  # not int8
    assert not qmm.supported(torch.zeros((4, 500), dtype=torch.bfloat16),
                             torch.zeros((500, 512), dtype=torch.int8))  # K % 128
    assert not qmm.supported(x, torch.zeros((512, 130), dtype=torch.int8))  # N % 128
    assert not qmm.supported(x.to(torch.int8), w)  # x must be float
    w4 = torch.zeros((256, 384), dtype=torch.int8)
    assert qmm.supported4(x, w4)
    assert not qmm.supported4(torch.zeros((4, 384), dtype=torch.bfloat16), w4)  # K
    assert not qmm.supported4(x, torch.zeros((256, 100), dtype=torch.int8))  # N % 128
    assert not qmm.supported4(torch.zeros((4, 512), dtype=torch.int32), w4)  # dtype
    with pytest.raises(ValueError, match="scale"):
        qmm.quantized_matmul4(x, w4, torch.ones((3, 384)))
    with pytest.raises(ValueError, match="contraction"):
        qmm.quantized_matmul(x, torch.zeros((256, 512), dtype=torch.int8), torch.ones(512))


def test_quantized_matmul_routes_through_kernel_wrappers(monkeypatch):
    """``use_kernel=True`` (or ``kernel.qmm="force"``) sends a 2-D product
    through the wrapper, whose plain version agrees with the plain
    composition, leading axes included; True keeps CPU tensors plain."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(np.float32))
    w = tq.quantize_matrix(torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32)))
    calls = []
    real = qmm.quantized_matmul
    monkeypatch.setattr(qmm, "quantized_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tq.matmul(x, w, use_kernel=True)
    want = tq.matmul(x, w, use_kernel=False)
    assert got.shape == want.shape == (2, 5, 384) and len(calls) == 1
    assert float((got - want).abs().max()) < 1e-3
    with config.patch({"kernel.qmm": True}):
        tq.matmul(x, w)
    assert len(calls) == 1  # CPU tensors stay plain under True
    with config.patch({"kernel.qmm": "force"}):
        tq.matmul(x, w)
    assert len(calls) == 2
    with config.patch({"kernel.qmm": False}):
        tq.matmul(x, w)
    assert len(calls) == 2


def test_quantized_matmul_plain_fallbacks():
    """Patterns the kernels do not take keep the plain composition on the
    CPU even when forced: 3-D expert stacks and K % 128 != 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(np.float32))
    experts = tq.quantize_matrix(torch.from_numpy(rng.standard_normal((2, 128, 256)).astype(np.float32)))
    torch.testing.assert_close(tq.matmul(x, experts, use_kernel=True),
                               tq.matmul(x, experts, use_kernel=False), rtol=0, atol=0)
    w_odd = tq.quantize_matrix(torch.from_numpy(rng.standard_normal((100, 256)).astype(np.float32)))
    x_odd = torch.from_numpy(rng.standard_normal((3, 100)).astype(np.float32))
    torch.testing.assert_close(tq.matmul(x_odd, w_odd, use_kernel=True),
                               tq.matmul(x_odd, w_odd, use_kernel=False), rtol=0, atol=0)
