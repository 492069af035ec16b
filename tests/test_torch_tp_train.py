"""Training under a (dp, tp) mesh (``llama.train_step(mesh=)``,
``loss_and_grads(mesh=)``, the autograd collectives of ``parallel/mesh``)
against the JAX package's ``train_step`` on four gloo CPU ranks.

One world of four ranks (``tests/torch_dist_worker.py``) runs every case
once; the JAX side runs here while they work.  Parameters come from JAX's
``init_params`` (converted bit for bit), tokens (4, 64) from a numpy seed;
each rank takes its shards (``parallel/mesh.shard_params`` under
``llama_param_specs``) and its rows (``batch_spec``).  The (2, 2) mesh is
``dryrun_multichip``'s train step (__graft_entry__.py:32-73: tokens
(2 * dp, 64)); (1, 4) and (4, 1) take the same tokens.

Every gradient leaf is re-assembled from the ranks' shards and held
against JAX's unsharded ``jax.value_and_grad(loss_fn)``, every updated
leaf against JAX's ``train_step``: a missing reduction in the backward
still leaves a finite loss, so the loss alone proves nothing.  Bars,
``tests/test_torch_train.py``'s: the loss within 1e-2 relative, each leaf
within 5e-2 relative Frobenius norm, the SGD step at lr = 100 (so the step
of a bf16 leaf is far above one ulp of it) held to the same 5e-2.  The MoE
cases run at float32 with SDPA attention, as the port's MoE forward test
does: in bf16 a rounding difference between the packages flips near-tied
expert choices, and a flipped choice moves every later token's place in
an expert's queue.  The QKV-bias and tied-embedding trees take SDPA
attention in bf16: they test where those leaves are sharded and summed,
which the attention path does not change, and JAX's SDPA compiles in a
fraction of its interpret-mode kernel's time.  Leaves replicated over the mesh (norms, the router)
must hold the same bytes on every rank, and every leaf the same bytes on
the ranks that differ only in their dp coordinate.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quantumattention_tpu.models import llama as jl
from quantumattention_tpu.parallel import mesh as jmesh
from quantumattention_tpu_torch.models import convert
from quantumattention_tpu_torch.models import llama as tl
from quantumattention_tpu_torch.parallel import mesh as qmesh
from torch_dist_worker import World

LOSS_REL = 1e-2
GRAD_REL = 5e-2
LR = 100.0
MOE = {"num_experts": 4, "num_experts_per_tok": 2, "attention_impl": "sdpa", "dtype": "float32"}
#: case -> (config overrides of ``tiny``, mesh (dp, tp), JAX init seed)
CASES = {
    "train_bf16_2x2": ({"attention_impl": "bf16"}, (2, 2), 0),
    "train_bf16_1x4": ({"attention_impl": "bf16"}, (1, 4), 0),
    "train_bf16_4x1": ({"attention_impl": "bf16"}, (4, 1), 0),
    "train_fp8_2x2": ({"attention_impl": "fp8"}, (2, 2), 0),
    "train_moe_2x2": (MOE, (2, 2), 12),
    "train_moe_drops_4x1": ({**MOE, "capacity_factor": 1.0}, (4, 1), 12),
    "train_qkv_bias_2x2": ({"attention_impl": "sdpa", "qkv_bias": True}, (2, 2), 3),
    "train_tied_2x2": ({"attention_impl": "sdpa", "tie_embeddings": True}, (2, 2), 5),
}
MOE_CASES = [name for name in CASES if "moe" in name]


def tokens():
    return np.random.default_rng(0).integers(0, 256, (4, 64)).astype(np.int32)


def jax_config(kw):
    return jl.tiny(**{k: getattr(jnp, v) if k == "dtype" else v for k, v in kw.items()})


def jax_params(name):
    kw, _, seed = CASES[name]
    return jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(seed), jax_config(kw)))


def to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def flat(tree, prefix="p."):
    """A parameter tree as {"p.layers.0.wq": tensor, ...} (the worker's
    ``_tree`` undoes it)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = to_torch(tree)
    return out


def paths(tree, prefix=""):
    """{"layers.0.moe.w_gate": leaf, ...} of a tree of dicts and lists (a
    spec, a tuple, is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in paths(sub, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in paths(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def f64(a):
    return np.asarray(a, np.float32).astype(np.float64)


def rel_norm(a, b):
    a, b = f64(a), f64(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {}
    for name, (kw, _, _) in CASES.items():
        inputs[name] = {**flat(jax_params(name)), "tokens": torch.from_numpy(tokens()).long(),
                        "lr": LR, "cfg": kw}
    inputs["train_rejects"] = {"tokens": torch.from_numpy(tokens()).long()}
    inputs["train_buckets"] = {**flat(jax_params("train_bf16_2x2")), "tokens": torch.from_numpy(tokens()).long(),
                               "cfg": CASES["train_bf16_2x2"][0]}
    inputs["autograd_collectives"] = {"x": torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 3, 8), dtype=np.float32))}
    w = World(4, tmp_path_factory.mktemp("tp_train_world"), inputs)
    yield w
    w.close()


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's unsharded loss, gradients and train step of each config, run
    once per (config, seed) and shared by the cases that use it."""
    cache = {}

    def run(name):
        kw, _, seed = CASES[name]
        key = (tuple(sorted(kw.items())), seed)
        if key not in cache:
            cfg = jax_config(kw)
            params = jl.init_params(jax.random.PRNGKey(seed), cfg)
            step = jax.jit(lambda p, t: (jax.value_and_grad(jl.loss_fn)(p, t, cfg),
                                         jl.train_step(p, t, cfg, lr=LR)))
            (loss, grads), (new, step_loss) = step(params, jnp.asarray(tokens()))
            as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
            cache[key] = {"loss": float(loss), "step_loss": float(step_loss), "grads": paths(as_np(grads)),
                          "new": paths(as_np(new)), "old": paths(as_np(params))}
        return cache[key]

    return run


def leaf_specs(name):
    kw, _, _ = CASES[name]
    cfg = tl.tiny(**{k: getattr(torch, v) if k == "dtype" else v for k, v in kw.items()})
    return paths(qmesh.llama_param_specs(cfg))


def assembled(res, name, key):
    """The whole leaves of tree ``key`` put back together from the shards
    of the ranks at dp coordinate 0, in tp order (numpy, bf16 kept)."""
    specs = leaf_specs(name)
    ranks = sorted((r for r in res if r["dp"] == 0), key=lambda r: r["tp"])
    trees = [paths(convert.params_to_numpy(r[key])) for r in ranks]
    out = {}
    for path, leaf in trees[0].items():
        dims = [d for d, ax in enumerate(specs[path]) if ax is not None]
        out[path] = np.concatenate([t[path] for t in trees], axis=dims[0]) if dims else leaf
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(world, jax_runs, name):
    """The whole batch's loss, the same float on every rank, within 1e-2 of
    JAX's (the loss of ``loss_and_grads`` and of the step)."""
    res, ref = world.case(name), jax_runs(name)
    for key in ("loss", "step_loss"):
        values = {float(r[key]) for r in res}
        assert len(values) == 1, (name, key, values)
        (t,) = values
        assert np.isfinite(t) and abs(t - ref[key]) <= LOSS_REL * abs(ref[key]), (name, key, t, ref[key])


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax(world, jax_runs, name):
    """Every gradient leaf, re-assembled from the shards, against JAX's
    unsharded gradient of the same batch."""
    grads, ref = assembled(world.case(name), name, "grads"), jax_runs(name)["grads"]
    assert grads.keys() == ref.keys()
    for path, g in grads.items():
        want = ref[path]
        assert g.shape == want.shape and g.dtype == want.dtype, (name, path, g.shape, want.shape)
        assert np.isfinite(f64(g)).all(), (name, path)
        assert rel_norm(g, want) < GRAD_REL, (name, path, rel_norm(g, want))


@pytest.mark.parametrize("name", list(CASES))
def test_updated_params_match_jax(world, jax_runs, name):
    """Each rank's SGD step on its shards, re-assembled, against JAX's
    ``train_step``; the step runs in place and leaves no autograd state."""
    res = world.case(name)
    new, ref = assembled(res, name, "new"), jax_runs(name)
    for path, p in new.items():
        assert p.dtype == ref["new"][path].dtype, (name, path)
        step_t = f64(p) - f64(ref["old"][path])
        step_j = f64(ref["new"][path]) - f64(ref["old"][path])
        assert np.linalg.norm(step_j) > 0, (name, path)
        assert rel_norm(step_t, step_j) < GRAD_REL, (name, path, rel_norm(step_t, step_j))
    assert not any(flag for r in res for flag in r["requires_grad"])


@pytest.mark.parametrize("name", list(CASES))
def test_replicas_hold_the_same_bytes(world, name):
    """Leaves replicated over the mesh (the norms, ``final_norm``, an MoE
    router) have the same gradient and updated bytes on all four ranks;
    every leaf is the same on the ranks that differ only in dp."""
    res, specs = world.case(name), leaf_specs(name)
    for key in ("grads", "new"):
        trees = [paths(convert.params_to_numpy(r[key])) for r in res]
        for path in trees[0]:
            for r, tree in zip(res, trees):
                if all(ax is None for ax in specs[path]):
                    peer = trees[0]
                else:
                    peer = trees[[q["tp"] == r["tp"] and q["dp"] == 0 for q in res].index(True)]
                assert tree[path].tobytes() == peer[path].tobytes(), (name, key, path, r["dp"], r["tp"])


@pytest.mark.parametrize("name", MOE_CASES)
def test_expert_choices_equal_across_tp(world, name):
    """Top-k routing picks the same experts on every tp rank of a dp row
    (the router is replicated and its input whole after the "f" op)."""
    res = world.case(name)
    assert all(r["experts"] for r in res)
    for r in res:
        peer = next(q for q in res if q["dp"] == r["dp"] and q["tp"] == 0)
        assert len(r["experts"]) == len(peer["experts"])
        for a, b in zip(r["experts"], peer["experts"]):
            assert torch.equal(a, b), name


def test_moe_drops_in_the_capacity_case(world):
    """At capacity factor 1 tokens drop (the ranks' kept assignments in
    layer 0's first forward are fewer than two a token), so the gradients
    of ``train_moe_drops_4x1`` match JAX's only where each rank claims
    capacity in the whole batch's queue (``moe.queue_offsets``)."""
    res = world.case("train_moe_drops_4x1")
    kept = sum(r["kept"][0] for r in res)
    assert 0 < kept < 2 * 4 * 63, kept


def test_matches_jax_sharded_train_step(world):
    """The (2, 2) case against JAX's own ``train_step`` jitted over a (2, 2)
    mesh of its CPU devices (tests/test_llama.py:86), not only the
    unsharded step."""
    cfg = jax_config(CASES["train_bf16_2x2"][0])
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    m = jmesh.make_mesh((2, 2), ("dp", "tp"), devices=jax.devices()[:4])
    sharded = jmesh.shard_params(params, m, jmesh.llama_param_specs(cfg))
    tok = jax.device_put(jnp.asarray(tokens()), jax.sharding.NamedSharding(m, jmesh.batch_spec()))
    new, loss = jax.jit(lambda p, t: jl.train_step(p, t, cfg, lr=LR))(sharded, tok)
    res = world.case("train_bf16_2x2")
    assert abs(float(res[0]["step_loss"]) - float(loss)) <= LOSS_REL * abs(float(loss))
    ours, old = assembled(res, "train_bf16_2x2", "new"), paths(jax.tree_util.tree_map(np.asarray, params))
    for path, want in paths(jax.tree_util.tree_map(np.asarray, new)).items():
        step_t, step_j = f64(ours[path]) - f64(old[path]), f64(want) - f64(old[path])
        assert rel_norm(step_t, step_j) < GRAD_REL, path


def test_gradient_buckets_do_not_change_the_sum(world):
    """The dp sum of gradients in pieces of 1,000 elements (every leaf of
    ``tiny`` cut) gives the same bytes as whole leaves."""
    for r in world.case("train_buckets"):
        assert r["calls_pieces"] > r["calls_whole"]
        assert r["equal"], r


@pytest.mark.parametrize("what", ["num_q_heads", "num_kv_heads", "intermediate_size", "vocab_size"])
def test_indivisible_config_is_refused(world, what):
    """A config that does not split over tp = 4 raises a ValueError naming
    the dimension, before any collective."""
    for r in world.case("train_rejects"):
        assert r[what].startswith("ValueError") and what in r[what] and "'tp'" in r[what], r[what]


def test_refusals(world):
    """A whole tree under a mesh (not this rank's shards), a quantized tree
    (not differentiable, as in JAX) and a mesh without a dp axis."""
    for r in world.case("train_rejects"):
        assert r["whole_tree"].startswith("ValueError") and "shard_params" in r["whole_tree"]
        assert r["quantized"].startswith("TypeError") and "not differentiable" in r["quantized"]
        assert r["no_dp_axis"].startswith("ValueError") and "'dp'" in r["no_dp_axis"]


def test_all_reduce_backward_is_identity(world):
    """``Axis.all_reduce`` (Megatron's "g"): the sum over tp forward, the
    incoming gradient unchanged backward."""
    x = world.case("autograd_collectives")[0]["x"]
    for r in world.case("autograd_collectives"):
        torch.testing.assert_close(r["sum"], 4 * x, rtol=0, atol=0)
        torch.testing.assert_close(r["sum_grad"], 3 * torch.ones_like(x), rtol=0, atol=0)


def test_all_gather_backward_slices(world):
    """``Axis.all_gather``: the ranks' tensors along ``dim``; backward, this
    rank's slice of the gradient."""
    res = world.case("autograd_collectives")
    x = res[0]["x"]
    for r in res:
        assert torch.equal(r["gathered"], torch.cat([x * (q + 1) for q in range(4)], dim=1))
        want = torch.arange(12, dtype=torch.float32).reshape(1, 12, 1).expand(2, 12, 8)
        assert torch.equal(r["gather_grad"], want[:, 3 * r["rank"]:3 * r["rank"] + 3])


def test_copy_backward_sums(world):
    """``Axis.copy`` (Megatron's "f"): ``x`` itself forward; backward the
    ranks' gradients summed (1 + 2 + 3 + 4)."""
    for r in world.case("autograd_collectives"):
        assert r["copy_equal"] and r["copy_shares_storage"]
        assert torch.equal(r["copy_grad"], torch.full((2, 3, 8), 10.0))


def test_no_grad_forward_is_unchanged(world):
    """Under ``torch.no_grad`` (serving) each method's forward gives the
    bytes of the plain collective and records no graph."""
    for r in world.case("autograd_collectives"):
        assert r["no_grad_equal"] and not r["no_grad_graph"]


# ---------------------------------------------------------------------------
# Presets and attention_block (no world)
# ---------------------------------------------------------------------------


FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_q_heads", "num_kv_heads",
          "head_dim", "rope_theta", "rms_norm_eps", "window", "tie_embeddings", "qkv_bias", "num_experts",
          "num_experts_per_tok", "capacity_factor", "attention_impl", "scaling_method")


@pytest.mark.parametrize("preset", ["llama3_70b", "qwen2_7b"])
def test_preset_fields_match_jax(preset):
    t, j = getattr(tl, preset)(), getattr(jl, preset)()
    for field in FIELDS:
        assert getattr(t, field) == getattr(j, field), (preset, field)
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert getattr(tl, preset)(num_layers=2).num_layers == 2


@pytest.mark.parametrize("impl", ["sdpa", "bf16"])
def test_attention_block_matches_jax(impl):
    """The self-attention sublayer (norm, QKV, RoPE, fused attention, wo,
    residual) at ``tiny``'s widths: float32 through SDPA within 1e-5 of
    JAX's largest output, bf16 through K1's plain version (JAX's kernel in
    interpret mode) within 2e-2."""
    dtype = {"sdpa": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[impl]
    jcfg = jl.tiny(attention_impl=impl, dtype=dtype[0])
    tcfg = tl.tiny(attention_impl=impl, dtype=dtype[1])
    layer_np = jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(7), jcfg))
    layer = convert.params_from_numpy(layer_np, tcfg, device="cpu")["layers"][0]
    x = np.random.default_rng(8).standard_normal((2, 64, jcfg.hidden_size), dtype=np.float32)
    jx = jnp.asarray(x, dtype[0])
    cos, sin = jl.rope_table(jnp.arange(64), jcfg.head_dim, jcfg.rope_theta)
    want = np.asarray(jl.attention_block(jcfg, layer_np["layers"][0], jx, cos, sin), np.float32)
    tcos, tsin = tl.rope_table(torch.arange(64), tcfg.head_dim, tcfg.rope_theta)
    got = tl.attention_block(tcfg, layer, to_torch(np.asarray(jx)), tcos, tsin)
    assert got.dtype == dtype[1] and got.shape == x.shape
    tol = 1e-5 if impl == "sdpa" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max(), rtol=0)


def test_attention_block_is_the_decoder_layers_first_half():
    """``attention_block`` then ``mlp_block`` is one decoder layer of
    ``forward`` (the same ops in the same order)."""
    cfg = tl.tiny(attention_impl="sdpa", dtype=torch.float32, num_layers=1)
    params = tl.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    toks = torch.from_numpy(tokens()[:1, :32]).long()
    cos, sin = tl.rope_table(torch.arange(32), cfg.head_dim, cfg.rope_theta)
    x = tl.quantized.embed_lookup(params["embed"], toks, cfg.dtype)
    layer = params["layers"][0]
    x = tl.mlp_block(cfg, layer, tl.attention_block(cfg, layer, x, cos, sin))
    assert torch.equal(tl.decode_head(params, x, cfg), tl.forward(params, toks, cfg))


def test_forward_without_mesh_is_unchanged():
    """``mesh=None`` takes no collective: the mesh helpers return no axes."""
    cfg = tl.tiny(attention_impl="sdpa", dtype=torch.float32)
    params = tl.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    assert tl.mesh_axes(params, cfg, None) == (None, None)
    toks = torch.from_numpy(tokens()[:1, :16]).long()
    assert torch.equal(tl.forward(params, toks, cfg), tl.forward(params, toks, cfg, mesh=None))
