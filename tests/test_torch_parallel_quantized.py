"""Ring attention over 8-bit shards, with several kernel blocks a shard,
and head-parallel fp8 attention against the JAX package's
(tests/test_parallel.py), on four gloo CPU ranks; see
``test_torch_parallel.py`` for how the world runs.
"""

import jax.numpy as jnp
import pytest

from quantumattention_tpu.ops.quant import quantize_head_wise, quantize_token_wise
from quantumattention_tpu.ops.sdpa import sdpa_reference
from quantumattention_tpu.parallel import mesh as jmesh
from quantumattention_tpu.parallel.ring import ring_attention as jring
from quantumattention_tpu.parallel.tp import head_parallel_attention as jhead
from torch_dist_worker import World
from torch_parallel_common import check, gathered, head_fp8_case, qkv, qkv_inputs, quantized_case, to_torch


def inputs():
    out = {}
    for name, arrs in (("head_parallel_fp8", head_fp8_case()),
                       ("ring_int8_head_wise", quantized_case("ring_int8_head_wise", quantize_head_wise)),
                       ("ring_int8_token_wise", quantized_case("ring_int8_token_wise", quantize_token_wise))):
        out[name] = dict(zip(("q", "k", "v", "sq", "sk"), map(to_torch, arrs)))
    out["ring_multiple_blocks"] = qkv_inputs("ring_multiple_blocks")
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("quantized_world"), inputs())
    yield w
    w.close()


@pytest.fixture(scope="module")
def sp_mesh():
    return jmesh.make_mesh((4,), ("sp",))


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh((4,), ("tp",))


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh((4,), ("tp",))

def test_ring_attention_int8_scales(world, sp_mesh):
    """Quantized ring: the int8 K payload rotates, head-wise scales stay."""
    q8, k8, v, sq, sk = map(jnp.asarray, quantized_case("ring_int8_head_wise", quantize_head_wise))
    want = jring(q8, k8, v, mesh=sp_mesh, scale_q=sq, scale_k=sk, is_causal=True)
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    check(gathered(world.case("ring_int8_head_wise"), 2), want, ref)


def test_ring_token_wise_scales(world, sp_mesh):
    """Token-wise: the K scales shard over the sequence and rotate with K."""
    q8, k8, v, sq, sk = map(jnp.asarray, quantized_case("ring_int8_token_wise", quantize_token_wise))
    want = jring(q8, k8, v, mesh=sp_mesh, scale_q=sq, scale_k=sk, is_causal=True)
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    check(gathered(world.case("ring_int8_token_wise"), 2), want, ref)


def test_ring_attention_multiple_blocks_per_shard(world, sp_mesh):
    """256 rows a shard: q_offset arithmetic across block boundaries."""
    q, k, v = map(jnp.asarray, qkv("ring_multiple_blocks"))
    want = jring(q, k, v, mesh=sp_mesh, is_causal=True, block_q=128, block_kv=128)
    check(gathered(world.case("ring_multiple_blocks"), 2), want, sdpa_reference(q, k, v, is_causal=True))


def test_head_parallel_fp8_scales(world, tp_mesh):
    q8, k8, v, sq, sk = map(jnp.asarray, head_fp8_case())
    want = jhead(q8, k8, v, mesh=tp_mesh, scale_q=sq, scale_k=sk, block_q=128, block_kv=128)
    ref = sdpa_reference(q8, k8, v, scale_q=sq, scale_k=sk)
    check(gathered(world.case("head_parallel_fp8"), 1), want, ref)
