"""Parameter checkpoints (models/io.py) against the JAX package's
(quantumattention_tpu/models/io.py): a round trip in the port, and files
written by either package loaded by the other, every leaf equal (bfloat16
saved as float32 and cast back, bit for bit); the ``.npz`` suffix rule and
the refusals with JAX's messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import io as jio
from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.models import quantized as jq
from quantumattention_tpu_torch.models import convert, io
from quantumattention_tpu_torch.models import llama as tl


def _trees(kind):
    """The same tree in both packages: a JAX init (dense, MoE, or int8 with
    fused projections), converted."""
    cfg = {"dense": {}, "moe": {"num_experts": 4}, "int8": {}}[kind]
    jp = jl.init_params(jax.random.PRNGKey(0), jl.tiny(**cfg))
    if kind == "int8":
        jp = jq.fuse_projections(jq.quantize_params(jp))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tl.tiny(**cfg), device="cpu")
    return jp, tp


def _equal(jtree, ttree):
    got = jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(ttree))
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jtree)))
    assert len(got) == len(want)
    for path, a in got:
        b = want[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("kind", ["dense", "moe", "int8"])
def test_roundtrip(tmp_path, kind):
    jp, tp = _trees(kind)
    io.save_params(tp, tmp_path / "ckpt")  # np.savez adds the suffix
    assert (tmp_path / "ckpt.npz").exists()
    template = convert._map(tp, torch.zeros_like)
    loaded = io.load_params(template, tmp_path / "ckpt")
    _equal(jp, loaded)
    assert loaded["final_norm"].dtype == torch.float32
    assert loaded["layers"][0]["attn_norm"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["dense", "moe", "int8"])
def test_files_cross_load(tmp_path, kind):
    jp, tp = _trees(kind)
    # JAX writes, the port reads into its own template.
    jio.save_params(jp, tmp_path / "from_jax.npz")
    _equal(jp, io.load_params(tp, tmp_path / "from_jax.npz"))
    # The port writes, JAX reads into its own template.
    io.save_params(tp, tmp_path / "from_torch.npz")
    with np.load(tmp_path / "from_torch.npz") as a, np.load(tmp_path / "from_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
        assert ("layers/0/w_qkv/q" if kind == "int8" else "layers/0/wq") in a.files
        assert ("layers/1/moe/w_router" in a.files) == (kind == "moe")
    _equal(jio.load_params(jp, tmp_path / "from_torch.npz"), tp)


def test_refusals_carry_jax_messages(tmp_path):
    jp, tp = _trees("dense")
    io.save_params({"embed": tp["embed"]}, tmp_path / "part.npz")
    for load, tree in ((io.load_params, tp), (jio.load_params, jp)):
        with pytest.raises(KeyError, match="checkpoint missing parameter 'final_norm'"):
            load(tree, tmp_path / "part.npz")
    io.save_params({"embed": tp["embed"][:5]}, tmp_path / "short.npz")
    msgs = []
    for load, tree in ((io.load_params, {"embed": tp["embed"]}), (jio.load_params, {"embed": jp["embed"]})):
        with pytest.raises(ValueError, match="shape mismatch for 'embed'") as e:
            load(tree, tmp_path / "short.npz")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_load_casts_to_the_template(tmp_path):
    """float32 values saved, loaded into a bfloat16 template: rounded as
    JAX's load rounds them; fp8 and int16 leaves go through float32."""
    x = torch.randn((4, 8), generator=torch.Generator().manual_seed(0))
    io.save_params({"w": x, "i": torch.arange(5, dtype=torch.int16),
                    "f8": x.to(torch.float8_e4m3fn)}, tmp_path / "c.npz")
    with np.load(tmp_path / "c.npz") as data:
        assert data["i"].dtype == np.float32 and data["f8"].dtype == np.float32
    got = io.load_params({"w": torch.zeros((4, 8), dtype=torch.bfloat16), "i": torch.zeros(5, dtype=torch.int16),
                          "f8": torch.zeros((4, 8), dtype=torch.float8_e4m3fn)}, tmp_path / "c.npz")
    want = jio.load_params({"w": jnp.zeros((4, 8), jnp.bfloat16)}, tmp_path / "c.npz")["w"]
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(want, np.float32))
    assert got["i"].tolist() == list(range(5)) and torch.equal(got["f8"], x.to(torch.float8_e4m3fn))
