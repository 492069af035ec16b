"""K10 at any GQA group and page size (fault 11), on the CPU.

- K10's plain version at a GQA group of 32 and at page sizes 8 and 512,
  over int8, e4m3, token-packed int4 and bf16 pages, against JAX's
  ``paged_decode_attention(..., use_dma=True, interpret=True)`` (the DMA
  path K10 ports; JAX's default would take the gathered reference at these
  shapes, ops/paged.py:560-571).  Tolerance as tests/test_torch_paged.py:
  max |diff| <= 1/32, RMSE < 1e-2, empty slots exactly zero.
- The paged engine at page sizes 8 and 512 against the slots engine of the
  port: equal first tokens, the JAX suite's ``agree >= n - 1`` after.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kv_int4 import _check, paged_inputs

from quantumattention_tpu.ops.paged import paged_decode_attention as jpaged
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.ops.paged import paged_decode_attention as tpaged
from quantumattention_tpu_torch.serving.engine import Engine


@pytest.mark.parametrize("kind", ["int8", "e4m3", "int4", "bf16"])
@pytest.mark.parametrize("group,ps,pps", [(32, 32, 2), (4, 8, 8), (2, 512, 1)],
                         ids=["g32", "ps8", "ps512"])
def test_paged_plain_matches_jax_dma_kernel(group, ps, pps, kind):
    b, hkv, d = 3, 2, 64
    tin, jin = paged_inputs(group + ps, b, hkv, group, ps, pps, d, kind, [pps * ps, 0, ps // 2 + 3])
    q, k, v, ks, vs, lens, table = tin
    got = tpaged(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs, pages_per_block=1)
    jq_, jk, jv, jks, jvs, jl_, jt = jin
    want = jpaged(jq_, jk, jv, jl_, jt, k_scale_pages=jks, v_scale_pages=jvs, pages_per_block=1,
                  use_dma=True, interpret=True)
    assert got.shape == (b, hkv * group, d)
    _check(got, want, empty=[1])


CFG = tl.tiny(attention_impl="bf16")


@pytest.fixture(scope="module")
def params():
    import jax

    from quantumattention_tpu.models import llama as jl

    tree = jl.init_params(jax.random.PRNGKey(0), jl.tiny())
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CFG, device="cpu")


@pytest.mark.parametrize("ps", [8, 512])
def test_paged_engine_any_page_size(params, ps):
    prompts = [[3, 17, 42, 99, 7], list(range(3, 60))]
    outs = []
    for extra in ({}, {"cache_backend": "paged", "page_size": ps, "prefill_bucket": max(ps, 128)}):
        eng = Engine(params, CFG, num_slots=2, max_len=512, cache_dtype=torch.int8, **extra)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        outs.append([r.output for r in reqs])
    for a, b in zip(*outs):
        assert len(b) == 6 and b[0] == a[0]
        assert sum(x == y for x, y in zip(a, b)) >= 5
