"""One rank of the parity tests of the parallel layer
(tests/test_torch_parallel*.py, tests/test_torch_tp_serving.py,
tests/test_torch_tp_train.py, and three card tests in
tests/test_torch_cuda.py).

    python torch_dist_worker.py <init> <rank> <world> <store> <inputs.pt> <out_dir>

Joins a gloo world through ``parallel/multihost.initialize_distributed``
(a ``file://`` store, so concurrent test runs cannot collide on a port;
``init`` "env" passes the world size and rank through ``WORLD_SIZE`` and
``RANK``, "args" as arguments), runs each case named in the inputs the
test wrote, on its inputs, and saves this rank's results, one dict a case,
to ``out_dir/rank<r>.pt``.  A case that raises records its traceback and
the next case runs.  :class:`World` starts the ranks.  Imports torch and
the port only.
"""

import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from quantumattention_tpu_torch import config, interface  # noqa: E402
from quantumattention_tpu_torch.models import llama, quantized  # noqa: E402
from quantumattention_tpu_torch.ops import qmm  # noqa: E402
from quantumattention_tpu_torch.parallel import mesh as qmesh  # noqa: E402
from quantumattention_tpu_torch.parallel import multihost, ring  # noqa: E402
from quantumattention_tpu_torch.parallel.ep import expert_parallel_ffn, moe_param_specs  # noqa: E402
from quantumattention_tpu_torch.parallel.pp import pipeline_apply  # noqa: E402
from quantumattention_tpu_torch.parallel.ring import ring_attention  # noqa: E402
from quantumattention_tpu_torch.parallel.tp import head_parallel_attention  # noqa: E402
from quantumattention_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: E402
from quantumattention_tpu_torch.serving import kv_cache as kvc  # noqa: E402
from quantumattention_tpu_torch.serving import tp as tp_lib  # noqa: E402
from quantumattention_tpu_torch.serving.engine import Engine  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def meshes():
    """The meshes the cases run on, built once (each is a collective)."""
    if not hasattr(meshes, "cache"):
        meshes.cache = {name: qmesh.make_mesh((4,), (name,), "cpu") for name in ("sp", "tp", "pp", "ep")}
        meshes.cache["dp_pp"] = qmesh.make_mesh((2, 2), ("dp", "pp"), "cpu")
    return meshes.cache


class counting:
    """Count the calls of ``module.attr`` inside the block."""

    def __init__(self, module, attr):
        self.module, self.attr, self.calls = module, attr, 0

    def __enter__(self):
        inner = getattr(self.module, self.attr)

        def wrapper(*a, **k):
            self.calls += 1
            return inner(*a, **k)

        self.inner = inner
        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is the result
        return {"error": f"{type(e).__name__}: {e}"}
    return {"error": "no error"}


# ---------------------------------------------------------------------------
# parallel/: ring, Ulysses, head-parallel, pipeline, experts
# ---------------------------------------------------------------------------


def _seq(inp, name="sp"):
    m = meshes()[name]
    return [qmesh.shard(inp[k], m, name, 2) for k in ("q", "k", "v")]


def _ring(inp, **kw):
    q, k, v = _seq(inp)
    m = meshes()["sp"]
    scales = {}
    if "sq" in inp:
        tok = inp["sq"].ndim == 3
        scales = {s: qmesh.shard(inp[s], m, "sp", 2) if tok else inp[s] for s in ("sq", "sk")}
        scales = {"scale_q": scales["sq"], "scale_k": scales["sk"]}
    with counting(ring, "flash_attention") as k1:
        out = ring_attention(q, k, v, mesh=m, **scales, **kw)
    return {"out": out, "calls": torch.tensor(k1.calls)}


@case
def ring_noncausal(inp):
    return _ring(inp, is_causal=False, block_q=128, block_kv=128)


@case
def ring_causal(inp):
    return _ring(inp, is_causal=True, block_q=128, block_kv=128)


@case
def ring_gqa_window(inp):
    return _ring(inp, is_causal=True, window=(192, 0), block_q=128, block_kv=128)


@case
def ring_local_inputs(inp):
    """Each rank is handed only its own shards (the test slices them)."""
    r = qmesh.axis_rank(meshes()["sp"], "sp")
    q, k, v = (inp[f"{n}{r}"] for n in "qkv")
    return {"out": ring_attention(q, k, v, mesh=meshes()["sp"], is_causal=True)}


@case
def ring_int8_head_wise(inp):
    return _ring(inp, is_causal=True)


@case
def ring_int8_token_wise(inp):
    return _ring(inp, is_causal=True)


@case
def ring_bad_scale_rank(inp):
    q, k, v = _seq(inp)
    s = torch.ones((1, 4, 128, 1))
    return error_of(lambda: ring_attention(q, k, v, mesh=meshes()["sp"], scale_q=s, scale_k=s))


@case
def ring_causal_skip(inp):
    return _ring(inp, is_causal=True, block_q=128, block_kv=128)


@case
def ring_multiple_blocks(inp):
    return _ring(inp, is_causal=True, block_q=128, block_kv=128)


@case
def ring_vs_ulysses(inp):
    q, k, v = _seq(inp)
    m = meshes()["sp"]
    return {"ring": ring_attention(q, k, v, mesh=m, is_causal=True),
            "ulysses": ulysses_attention(q, k, v, mesh=m, is_causal=True)}


@case
def ulysses(inp):
    q, k, v = _seq(inp)
    return {"out": ulysses_attention(q, k, v, mesh=meshes()["sp"], is_causal=True)}


@case
def ulysses_indivisible(inp):
    q, k, v = _seq(inp)
    return error_of(lambda: ulysses_attention(q, k, v, mesh=meshes()["sp"]))


@case
def head_parallel(inp):
    return {"out": head_parallel_attention(inp["q"], inp["k"], inp["v"], mesh=meshes()["tp"],
                                           is_causal=True)}


@case
def head_parallel_fp8(inp):
    return {"out": head_parallel_attention(inp["q"], inp["k"], inp["v"], mesh=meshes()["tp"],
                                           scale_q=inp["sq"], scale_k=inp["sk"])}


@case
def head_parallel_indivisible(inp):
    return error_of(lambda: head_parallel_attention(inp["q"], inp["k"], inp["v"],
                                                    mesh=meshes()["tp"]))


@case
def pipeline_sequential(inp):
    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    return {"out": pipeline_apply(stage_fn, {"w": inp["w"], "b": inp["b"]}, inp["x"],
                                  mesh=meshes()["pp"])}


@case
def pipeline_attention(inp):
    heads, s, d = 2, 128, 64

    def stage_fn(p, a):
        b = a.shape[0]
        qkv = a.reshape(b, s, heads, d).transpose(1, 2).to(torch.bfloat16)
        att = interface.attn_func(qkv, qkv, qkv, is_causal=True)
        att = att.transpose(1, 2).reshape(b, s, heads * d)
        return a + att.float() @ p["wo"]

    return {"out": pipeline_apply(stage_fn, {"wo": inp["wo"]}, inp["x"], mesh=meshes()["dp_pp"])}


@case
def pod_mesh(inp):
    m = multihost.pod_mesh(dp=2, sp=2, device_type="cpu")
    sizes = [qmesh.axis_size(m, a) for a in ("dp", "sp", "tp")]
    errors = [error_of(lambda: multihost.local_batch_size(7, m, "dp"))["error"],
              error_of(lambda: multihost.pod_mesh(dp=3, device_type="cpu"))["error"]]
    return {"sizes": torch.tensor(sizes), "local": torch.tensor(multihost.local_batch_size(16, m, "dp")),
            "errors": errors}


@case
def expert_parallel(inp):
    moe = {k: inp[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    return {"out": expert_parallel_ffn(moe, inp["x"], mesh=meshes()["ep"], num_experts_per_tok=2,
                                       capacity_factor=4.0)}


@case
def expert_parallel_int8(inp):
    """int8 expert stacks, sliced before the call, through the wrappers
    of K5/K6 (their plain versions on the CPU), one call an expert."""
    moe = {"w_router": inp["w_router"],
           **{k: quantized.quantize_matrix(inp[k]) for k in ("w_gate", "w_up", "w_down")}}
    m = meshes()["ep"]
    local = qmesh.shard_params(moe, m, qmesh.quantized_specs(moe, moe_param_specs("ep")))
    with config.patch({"kernel.qmm": "force"}), counting(qmm, "quantized_matmul") as k5:
        out = expert_parallel_ffn(local, inp["x"], mesh=m, num_experts_per_tok=2, capacity_factor=4.0)
    return {"out": out, "local_experts": torch.tensor(local["w_gate"]["q"].shape[0]),
            "k5_calls": torch.tensor(k5.calls)}


@case
def expert_parallel_bad_shapes(inp):
    moe6 = {k: inp[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    m = meshes()["ep"]
    return {"experts": error_of(lambda: expert_parallel_ffn(moe6, torch.zeros((8, 4, 64)), mesh=m))["error"],
            "batch": error_of(lambda: expert_parallel_ffn(
                {k: inp[k + "8"] for k in ("w_router", "w_gate", "w_up", "w_down")},
                torch.zeros((3, 4, 64)), mesh=m))["error"]}


@case
def ring_across_processes(inp):
    m = multihost.pod_mesh(dp=1, sp=2, tp=1, device_type="cpu")
    q, k, v = (qmesh.shard(inp[n], m, "sp", 2) for n in "qkv")
    return {"out": ring_attention(q, k, v, mesh=m, is_causal=True),
            "single": torch.tensor(multihost.initialize_distributed(num_processes=1) is None)}


# ---------------------------------------------------------------------------
# serving/tp.py and Engine(mesh=)
# ---------------------------------------------------------------------------


def _tp_decode(inp, **kw):
    """The whole cache cut to this rank's KV heads by ``shard_cache``, the
    query to its heads, then K4's wrapper on them."""
    m = meshes()["tp"]
    cache = tp_lib.shard_cache(kvc.KVCache(k=inp["k"], v=inp["v"], lengths=inp["lengths"],
                                           k_scale=inp.get("ks"), v_scale=inp.get("vs")), m)
    return {"out": tp_lib.decode_attention_tp(
        qmesh.shard(inp["q"], m, "tp", 1), cache.k, cache.v, cache.lengths, mesh=m,
        k_scale=cache.k_scale, v_scale=cache.v_scale, **kw),
        "cache_heads": torch.tensor(cache.k.shape[1])}


@case
def tp_decode_int8(inp):
    return _tp_decode(inp)


@case
def tp_decode_bf16_window(inp):
    return _tp_decode(inp, window=(63, 0))


@case
def tp_decode_validation(inp):
    m = meshes()["tp"]
    kv = torch.zeros((2, 2, 128, 64), dtype=torch.bfloat16)
    lens = torch.full((2,), 8, dtype=torch.int32)
    return {"heads": error_of(lambda: qmesh.shard(torch.zeros((2, 6, 64)), m, "tp", 1))["error"],
            "verify": error_of(lambda: tp_lib.decode_attention_tp(
                torch.zeros((2, 2, 2, 64), dtype=torch.bfloat16), kv[:, :1], kv[:, :1], lens,
                mesh=m))["error"]}


def _tiny_fp32():
    return llama.tiny(attention_impl="sdpa", dtype=torch.float32)


def _tree(inp, prefix="p."):
    """The parameter tree the test flattened into ``inp``."""
    flat = {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}
    tree = {"layers": []}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        if parts[0] == "layers":
            idx = int(parts[1])
            while len(tree["layers"]) <= idx:
                tree["layers"].append({})
            node, parts = tree["layers"][idx], parts[2:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@case
def tp_prefill(inp):
    cfg = _tiny_fp32()
    params = tp_lib.shard_serving_params(_tree(inp), cfg, meshes()["tp"])
    logits, kv = tp_lib.forward_prefill_tp(params, inp["tokens"], cfg=cfg, mesh=meshes()["tp"])
    out = {"logits": logits}
    for i, (k, v) in enumerate(kv):
        out[f"k{i}"], out[f"v{i}"] = k, v
    return out


@case
def param_specs_quantized(inp):
    cfg = _tiny_fp32()
    tree = _tree(inp)
    specs = qmesh.param_specs_for(tree, cfg)
    local = qmesh.shard_params(tree, meshes()["tp"], specs)
    out = {f"{name}.{part}": local[name][part] if name == "embed" else local["layers"][0][name][part]
           for name in ("wq", "wo", "embed") for part in ("q", "s")}
    out["specs"] = [tuple(specs["layers"][0][n][p]) for n in ("wq", "wo") for p in ("q", "s")] + [
        tuple(specs["embed"][p]) for p in ("q", "s")]
    return out


def _engine_outputs(reqs):
    return {"outputs": [list(r.output) for r in reqs], "done": [r.done for r in reqs]}


@case
def engine_serves(inp):
    cfg = _tiny_fp32()
    eng = Engine(_tree(inp), cfg, num_slots=2, max_len=256, cache_dtype=torch.int8,
                 mesh=meshes()["tp"])
    req = eng.submit([5, 9, 23, 51, 7, 12], max_new_tokens=4)
    eng.run_to_completion()
    return {**_engine_outputs([req]), "cache_heads": torch.tensor(eng.caches[0].k.shape[1])}


@case
def engine_quantized_burst(inp):
    cfg = _tiny_fp32()
    qparams = quantized.init_quantized_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    first = []
    solo = Engine(qparams, cfg, num_slots=2, max_len=256, cache_dtype=torch.int8)
    reqs = [solo.submit([1 + i, 7, 3, 9], max_new_tokens=1) for i in range(2)]
    solo.run_to_completion()
    first = [r.output[0] for r in reqs]
    outputs = {}
    for burst in (4, None):  # bursts under a mesh loop the single step
        eng = Engine(qparams, cfg, num_slots=2, max_len=256, cache_dtype=torch.int8,
                     mesh=meshes()["tp"])
        reqs = [eng.submit([1 + i, 7, 3, 9], max_new_tokens=9) for i in range(2)]
        eng.run_to_completion(decode_burst=burst)
        outputs[burst] = [list(r.output) for r in reqs]
        if burst:
            rec = {**_engine_outputs(reqs), "generated": torch.tensor(eng.stats["generated_tokens"]),
                   "bursts": torch.tensor(eng._backend.stats["bursts"]),
                   "captures": torch.tensor(eng._backend.stats["graph_captures"])}
    return {**rec, "solo_first": first, "stepwise": outputs[None]}


@case
def engine_chunked(inp):
    cfg = _tiny_fp32()
    eng = Engine(_tree(inp), cfg, num_slots=2, max_len=256, cache_dtype=torch.int8,
                 prefill_chunk=64, mesh=meshes()["tp"])
    long_prompt = [(3 * i) % 97 + 1 for i in range(150)]
    short = eng.submit([5, 9, 23], max_new_tokens=8)
    eng.step()
    produced = [len(short.output)]
    long_req = eng.submit(list(long_prompt), max_new_tokens=3)
    while long_req.prefill_pos < len(long_prompt):
        eng.step()
        produced.append(len(short.output))
    eng.run_to_completion()
    return {**_engine_outputs([short, long_req]), "produced": produced}


@case
def engine_rejects(inp):
    cfg = _tiny_fp32()
    tree, m = _tree(inp), meshes()["tp"]
    small = llama.tiny(num_kv_heads=2, num_q_heads=4)
    return {
        "paged": error_of(lambda: Engine(tree, cfg, num_slots=2, max_len=256, mesh=m,
                                         cache_backend="paged", page_size=64))["error"],
        "heads": error_of(lambda: Engine(llama.init_params(torch.Generator().manual_seed(0), small, "cpu"),
                                         small, num_slots=2, max_len=256, mesh=m))["error"],
        "draft": error_of(lambda: Engine(tree, cfg, num_slots=2, max_len=256, mesh=m,
                                         draft=(tree, cfg)))["error"],
        "block_kv": error_of(lambda: Engine(tree, cfg, num_slots=2, max_len=256, mesh=m,
                                            decode_block_kv=1024))["error"],
        "fused": error_of(lambda: Engine(quantized.fuse_projections(quantized.quantize_params(tree)),
                                         cfg, num_slots=2, max_len=256, mesh=m))["error"],
    }


@case
def int4_tree(inp):
    """A w4a16 tree whose row-split products keep whole packing blocks a
    rank, through K7's wrapper (its plain version on the CPU)."""
    cfg = llama.tiny(attention_impl="sdpa", dtype=torch.float32, hidden_size=256,
                     intermediate_size=1024, num_q_heads=16, num_kv_heads=4)
    params = quantized.quantize_params_int4(
        llama.init_params(torch.Generator().manual_seed(1), cfg, "cpu"))
    m = meshes()["tp"]
    tokens = torch.tensor([[3, 17, 42, 99, 7, 23, 5, 1]])
    with config.patch({"kernel.qmm": "force"}):
        single, _ = llama.forward_prefill(params, tokens, cfg)
        with counting(qmm, "quantized_matmul4") as k7:
            logits, _ = tp_lib.forward_prefill_tp(tp_lib.shard_serving_params(params, cfg, m),
                                                  tokens, cfg=cfg, mesh=m)
        calls = k7.calls
    bad = llama.tiny(dtype=torch.float32)
    misaligned = quantized.quantize_params_int4(llama.init_params(torch.Generator().manual_seed(1), bad, "cpu"))
    return {"single": single, "logits": logits, "k7_calls": torch.tensor(calls),
            "misaligned": error_of(lambda: tp_lib.shard_serving_params(misaligned, bad, m))["error"]}


# ---------------------------------------------------------------------------
# Training under a (dp, tp) mesh (tests/test_torch_tp_train.py)
# ---------------------------------------------------------------------------


def train_mesh(shape, device_type="cpu"):
    """The ("dp", "tp") mesh of ``shape``, built once a world."""
    cache = train_mesh.__dict__.setdefault("cache", {})
    if (shape, device_type) not in cache:
        cache[shape, device_type] = qmesh.make_mesh(shape, ("dp", "tp"), device_type)
    return cache[shape, device_type]


class recording_experts:
    """Every ``moe.router_topk`` call's experts inside the block, in order."""

    def __init__(self):
        from quantumattention_tpu_torch.models import moe

        self.moe, self.experts, self.kept = moe, [], []

    def __enter__(self):
        self.topk, self.dispatch = self.moe.router_topk, self.moe.make_dispatch_combine

        def topk(logits, k):
            gates, experts = self.topk(logits, k)
            self.experts.append(experts.clone())
            return gates, experts

        def dispatch(*a, **kw):
            out = self.dispatch(*a, **kw)
            self.kept.append(float(out[0].float().sum()))
            return out

        self.moe.router_topk, self.moe.make_dispatch_combine = topk, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.router_topk, self.moe.make_dispatch_combine = self.topk, self.dispatch


def train_config(inp):
    kw = dict(inp["cfg"])
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return llama.tiny(**kw)


def _train(inp, shape):
    """This rank's loss and gradients (``loss_and_grads(mesh=)``), then one
    ``train_step(mesh=)`` on its shards of the test's tree and its rows of
    the test's tokens."""
    cfg, m = train_config(inp), train_mesh(shape)
    local = qmesh.shard_params(_tree(inp), m, qmesh.llama_param_specs(cfg))
    tokens = qmesh.shard(inp["tokens"], m, "dp", 0)
    with recording_experts() as rec:
        loss, grads = llama.loss_and_grads(local, tokens, cfg, mesh=m)
        new, step_loss = llama.train_step(local, tokens, cfg, lr=inp["lr"], mesh=m)
    return {"loss": loss, "step_loss": step_loss, "grads": grads, "new": new,
            "dp": qmesh.axis_rank(m, "dp"), "tp": qmesh.axis_rank(m, "tp"),
            "experts": rec.experts, "kept": rec.kept,
            "requires_grad": [p.requires_grad for p in llama.leaves(new)]}


@case
def train_bf16_2x2(inp):
    return _train(inp, (2, 2))


@case
def train_bf16_1x4(inp):
    return _train(inp, (1, 4))


@case
def train_bf16_4x1(inp):
    return _train(inp, (4, 1))


@case
def train_fp8_2x2(inp):
    return _train(inp, (2, 2))


@case
def train_moe_2x2(inp):
    return _train(inp, (2, 2))


@case
def train_moe_drops_4x1(inp):
    return _train(inp, (4, 1))


@case
def train_qkv_bias_2x2(inp):
    return _train(inp, (2, 2))


@case
def train_tied_2x2(inp):
    return _train(inp, (2, 2))


@case
def train_rejects(inp):
    m, tokens = train_mesh((1, 4)), inp["tokens"]

    def step(cfg, params=None, mesh=m):
        if params is None:
            params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        return error_of(lambda: llama.train_step(params, tokens, cfg, mesh=mesh))["error"]

    tiny = llama.tiny(attention_impl="bf16")
    whole = llama.init_params(torch.Generator().manual_seed(0), tiny, "cpu")
    return {
        "num_q_heads": step(llama.tiny(num_q_heads=6, num_kv_heads=2)),
        "num_kv_heads": step(llama.tiny(num_kv_heads=2)),
        "intermediate_size": step(llama.tiny(intermediate_size=250)),
        "vocab_size": step(llama.tiny(vocab_size=254)),
        "whole_tree": step(tiny, whole),
        "quantized": step(tiny, tp_lib.shard_serving_params(quantized.quantize_params(whole), tiny, m)),
        "no_dp_axis": step(tiny, whole, qmesh.make_mesh((4,), ("tp",), "cpu")),
    }


@case
def train_buckets(inp):
    """The dp gradient sum in whole leaves, then in pieces of 1,000
    elements, over the same step."""
    cfg, m = train_config(inp), train_mesh((2, 2))
    local = qmesh.shard_params(_tree(inp), m, qmesh.llama_param_specs(cfg))
    tokens = qmesh.shard(inp["tokens"], m, "dp", 0)
    with counting(qmesh, "all_reduce") as whole_calls:
        _, whole = llama.loss_and_grads(local, tokens, cfg, mesh=m)
    saved, qmesh.BUCKET_ELEMENTS = qmesh.BUCKET_ELEMENTS, 1000
    try:
        with counting(qmesh, "all_reduce") as piece_calls:
            _, pieces = llama.loss_and_grads(local, tokens, cfg, mesh=m)
    finally:
        qmesh.BUCKET_ELEMENTS = saved
    pairs = list(zip(llama.leaves(whole), llama.leaves(pieces)))
    return {"equal": all(torch.equal(a, b) for a, b in pairs), "calls_whole": whole_calls.calls,
            "calls_pieces": piece_calls.calls}


@case
def autograd_collectives(inp):
    """Each ``Axis`` method's forward and backward over tp = 4, and its
    forward under ``torch.no_grad`` beside the plain collective."""
    m = train_mesh((1, 4))
    tp, r = qmesh.axis(m, "tp"), qmesh.axis_rank(m, "tp")
    x = inp["x"].clone().requires_grad_(True)
    total = tp.all_reduce(x)
    total.backward(torch.full_like(total, 3.0))
    out = {"rank": r, "x": inp["x"], "sum": total.detach(), "sum_grad": x.grad.clone()}
    mine = (inp["x"] * (r + 1)).requires_grad_(True)
    gathered = tp.all_gather(mine, dim=1)
    gathered.backward(torch.arange(12, dtype=torch.float32).reshape(1, 12, 1).expand_as(gathered))
    out.update(gathered=gathered.detach(), gather_grad=mine.grad.clone())
    x.grad = None
    copied = tp.copy(x)
    copied.backward(torch.full_like(copied, float(r + 1)))
    out.update(copy_equal=torch.equal(copied, x), copy_shares_storage=copied.data_ptr() == x.data_ptr(),
               copy_grad=x.grad.clone())
    with torch.no_grad():
        pairs = [(tp.all_reduce(x), qmesh.all_reduce(x, m, "tp")),
                 (tp.all_gather(x, 1), qmesh.all_gather(x, m, "tp", 1)), (tp.copy(x), x)]
    out.update(no_grad_equal=all(torch.equal(a, b) for a, b in pairs),
               no_grad_graph=any(a.grad_fn is not None for a, _ in pairs))
    return out


class World:
    """The ranks of one suite, started together as processes of their own;
    their results are read when a test first asks.  Every wait is bounded:
    past ``timeout_s`` the ranks are killed and the asking test fails."""

    def __init__(self, size: int, tmp, inputs: dict, timeout_s: float = 180.0, init: str = "args"):
        tmp = str(tmp)
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        rest = [str(size), os.path.join(tmp, "store"), os.path.join(tmp, "inputs.pt"), tmp]
        self.tmp, self.size, self.deadline = tmp, size, time.monotonic() + timeout_s
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), init, str(r), *rest],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(size)
        ]
        self._results = None

    def results(self) -> list:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                self.close()
                raise RuntimeError("the ranks did not finish in time (a hung collective?)")
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{log}")
            self._results = [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False)
                             for r in range(self.size)]
            self.logs = logs
        return self._results

    def case(self, name: str) -> list:
        """Every rank's result of case ``name``; a case that crashed fails."""
        out = [r[name] for r in self.results()]
        for r, res in enumerate(out):
            if "crash" in res:
                raise AssertionError(f"rank {r}, case {name}:\n{res['crash']}")
        return out

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# On the card: two gloo ranks sharing cuda:0 (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def _card_randn(shape, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda")


@case
def ring_fp8_token_wise_card(inp):
    """Ring over two ranks' e4m3 token-wise shards (K1 with residuals and
    offsets), beside one unsharded K1 call on the same codes."""
    from quantumattention_tpu_torch.ops import quant
    from quantumattention_tpu_torch.ops.flash import flash_attention

    m = qmesh.make_mesh((2,), ("sp",))
    q, k, v = (_card_randn((1, 8, 1024, 128), seed) for seed in (1, 2, 3))
    q8, sq = quant.quantize_token_wise(q)
    k8, sk = quant.quantize_token_wise(k)
    v = v.to(torch.bfloat16)
    local = lambda t: qmesh.shard(t, m, "sp", 2)
    before = flash_attention.launches
    out = ring_attention(local(q8), local(k8), local(v), mesh=m, scale_q=local(sq), scale_k=local(sk),
                         is_causal=True)
    launched = flash_attention.launches - before
    whole = flash_attention(q8, k8, v, scale_q=sq, scale_k=sk, is_causal=True)
    return {"out": out.cpu(), "whole": whole.cpu(), "launches": torch.tensor(launched),
            "q8": q8.float().cpu(), "k8": k8.float().cpu(), "v": v.float().cpu(),
            "sq": sq.cpu(), "sk": sk.cpu(), "device": str(out.device)}


@case
def tp_decode_card(inp):
    """K4 on each rank's heads of an int8 slot cache (32/8 heads, D 128),
    beside one unsharded K4 call."""
    from quantumattention_tpu_torch.ops import quant
    from quantumattention_tpu_torch.ops.decode import decode_attention

    m = qmesh.make_mesh((2,), ("tp",))
    lens = torch.tensor([0, 57, 900, 2047], dtype=torch.int32, device="cuda")
    q = _card_randn((4, 32, 128), 4).to(torch.bfloat16)
    kc, ks = quant.dynamically_quantize_int8(_card_randn((4, 8, 2048, 128), 5), reduction_dim=-1)
    vc, vs = quant.dynamically_quantize_int8(_card_randn((4, 8, 2048, 128), 6), reduction_dim=-1)
    heads = lambda t: qmesh.shard(t, m, "tp", 1)
    before = decode_attention.launches
    out = tp_lib.decode_attention_tp(heads(q), heads(kc), heads(vc), lens, mesh=m,
                                     k_scale=heads(ks), v_scale=heads(vs))
    launched = decode_attention.launches - before
    whole = decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    return {"out": out.cpu(), "whole": whole.cpu(), "launches": torch.tensor(launched),
            "lens": lens.cpu()}


@case
def tp_train_card(inp):
    """One SGD step of ``tiny`` (bf16 attention: K1, K2, K3) on a (dp 1,
    tp 2) mesh of two ranks sharing cuda:0, beside one card's step on the
    whole tree and batch through the same kernels."""
    from quantumattention_tpu_torch.ops.flash import flash_attention
    from quantumattention_tpu_torch.ops.flash_bwd import flash_bwd_dkv, flash_bwd_dq

    m = train_mesh((1, 2), "cuda")
    cfg = llama.tiny(attention_impl="bf16")
    whole = llama.init_params(torch.Generator("cuda").manual_seed(7), cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(8)).cuda()
    copy = llama.tree_like(whole, [p.clone() for p in llama.leaves(whole)])  # shards share replicated leaves
    local = qmesh.shard_params(copy, m, qmesh.llama_param_specs(cfg))
    cpu = lambda tree: llama.tree_like(tree, [t.to("cpu", copy=True) for t in llama.leaves(tree)])  # noqa: E731
    old = cpu(whole)
    one_loss, one_grads = llama.loss_and_grads(whole, tokens, cfg)
    whole, _ = llama.train_step(whole, tokens, cfg, lr=100.0)
    counters = (flash_attention, flash_bwd_dq, flash_bwd_dkv)
    before = [fn.launches for fn in counters]
    loss, grads = llama.loss_and_grads(local, tokens, cfg, mesh=m)
    local, step_loss = llama.train_step(local, tokens, cfg, lr=100.0, mesh=m)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    return {"loss": float(loss), "step_loss": float(step_loss), "one_loss": float(one_loss),
            "grads": cpu(grads), "new": cpu(local), "one_grads": cpu(one_grads), "one_new": cpu(whole),
            "old": old, "launches": launched, "tp": qmesh.axis_rank(m, "tp"), "device": str(tokens.device)}


def main() -> None:
    init, rank, world, store, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if init == "env":
        os.environ["WORLD_SIZE"], os.environ["RANK"] = str(world), str(rank)
        multihost.initialize_distributed(coordinator_address=f"file://{store}")
    else:
        multihost.initialize_distributed(f"file://{store}", world, rank)
    data = torch.load(inputs, weights_only=False)
    results = {}
    for name, inp in data.items():
        try:
            results[name] = CASES[name](inp)
        except Exception:  # noqa: BLE001 — one failing case fails one test
            results[name] = {"crash": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
