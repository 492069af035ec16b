"""Hugging Face checkpoints in the port (models/hf.py, Engine.from_hf).

Mirrors tests/test_hf.py:44-290: transformers Llama, Qwen2 and Mixtral
models built from a config in the test (nothing is downloaded) load into
the port, whose logits are held to HF's at the JAX suite's tolerances
(relative logit RMSE 2e-3, 5e-3 for Mixtral, 4e-3 through a checkpoint
directory).  Beyond the mirror: the converted trees equal the JAX loader's
(float32, bit for bit), the streamed quantized tree equals the tree
quantized after the fact bit for bit (int8, int4, and Mixtral's expert
stacks), the port's safetensors reader equals ``safetensors.torch.
load_file`` on a ``save_pretrained`` directory (sharded too), and
``Engine.from_hf`` serves on the CPU.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_hf_checkpoint as ckpt

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from quantumattention_tpu.models import hf as jhf  # noqa: E402
from quantumattention_tpu.models import llama as jl  # noqa: E402
from quantumattention_tpu_torch.models import convert, hf  # noqa: E402
from quantumattention_tpu_torch.models import llama as tl  # noqa: E402
from quantumattention_tpu_torch.models import quantized as tq  # noqa: E402
from quantumattention_tpu_torch.serving.engine import Engine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _logits_ours(params, cfg, tokens_np):
    return tl.forward(params, torch.from_numpy(tokens_np), cfg).float().numpy()


def _logits_hf(model, tokens_np):
    with torch.no_grad():
        return model(torch.tensor(tokens_np, dtype=torch.long)).logits.float().numpy()


def _assert_close(a, b, tol):
    scale = np.maximum(np.std(b), 1e-6)
    rmse = float(np.sqrt(np.mean((a - b) ** 2))) / scale
    assert rmse < tol, f"relative logit rmse {rmse}"


def _same_as_jax(params, state_dict, jcfg_kw, **kw):
    """The port's tree equals the JAX loader's on the same state dict."""
    jcfg = jhf._cfg_with_detected_bias(jhf.config_from_hf(*jcfg_kw), state_dict)
    want = jax.tree_util.tree_map(np.asarray, jhf.params_from_hf(state_dict, jcfg, **kw))
    got = dict(jax.tree_util.tree_leaves_with_path(convert.params_to_numpy(params)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(got)
    for path, b in flat:
        np.testing.assert_array_equal(got[path], b)


def _tiny_llama(**kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, attention_bias=False)
    base.update(kw)
    return transformers.LlamaConfig(**base)


def test_hf_llama_logit_parity():
    hf_cfg = _tiny_llama()
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = hf.config_from_hf(hf_cfg, dtype=torch.float32, attention_impl="sdpa")
    params = hf.params_from_hf(model.state_dict(), cfg, device="cpu")
    tokens = np.array([[3, 17, 42, 99, 7, 23, 56, 81]], np.int64)
    _assert_close(_logits_ours(params, cfg, tokens), _logits_hf(model, tokens), 2e-3)
    _same_as_jax(params, model.state_dict(), (hf_cfg,), dtype=jnp.float32)


def test_hf_llama_tied_embeddings_parity():
    hf_cfg = _tiny_llama(vocab_size=96, intermediate_size=96, num_hidden_layers=1, num_key_value_heads=4,
                         rms_norm_eps=1e-6, tie_word_embeddings=True)
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = hf.config_from_hf(hf_cfg, dtype=torch.float32, attention_impl="sdpa")
    assert cfg.tie_embeddings
    params = hf.params_from_hf(model.state_dict(), cfg, device="cpu")
    assert "lm_head" not in params
    tokens = np.array([[5, 9, 2, 41, 8]], np.int64)
    _assert_close(_logits_ours(params, cfg, tokens), _logits_hf(model, tokens), 2e-3)


def test_hf_qwen2_bias_parity():
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False, use_sliding_window=False,
    )
    torch.manual_seed(2)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    params, cfg = hf.load_hf_model(model, dtype=torch.float32, device="cpu")
    assert cfg.qkv_bias, "loader failed to detect q/k/v biases"
    cfg = hf.config_from_hf(hf_cfg, dtype=torch.float32, attention_impl="sdpa", qkv_bias=True)
    tokens = np.array([[12, 4, 77, 31, 9, 64]], np.int64)
    _assert_close(_logits_ours(params, cfg, tokens), _logits_hf(model, tokens), 2e-3)
    _same_as_jax(params, model.state_dict(), (hf_cfg,), dtype=jnp.float32)


def _tiny_mixtral():
    return transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=None,
    )


def test_hf_mixtral_moe_parity():
    hf_cfg = _tiny_mixtral()
    torch.manual_seed(3)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    # Ample capacity: HF computes every routed token, so parity needs the
    # dense dispatch to drop none.
    cfg = hf.config_from_hf(hf_cfg, dtype=torch.float32, attention_impl="sdpa", capacity_factor=4.0)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.window) == (4, 2, None)
    params = hf.params_from_hf(model.state_dict(), cfg, device="cpu")
    moe = params["layers"][0]["moe"]
    assert moe["w_router"].dtype == torch.float32 and moe["w_router"].shape == (64, 4)
    assert moe["w_gate"].shape == (4, 64, 96) and moe["w_down"].shape == (4, 96, 64)
    tokens = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    _assert_close(_logits_ours(params, cfg, tokens), _logits_hf(model, tokens), 5e-3)
    _same_as_jax(params, model.state_dict(), (hf_cfg,), dtype=jnp.float32)


def test_hf_checkpoint_dir_roundtrip(tmp_path):
    """load_hf_checkpoint reads config.json and the safetensors files with
    the port's own reader and reproduces the same logits."""
    hf_cfg = _tiny_llama(vocab_size=96, intermediate_size=96, num_hidden_layers=1)
    torch.manual_seed(4)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    params, cfg = hf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu",
                                        attention_impl="sdpa")
    tokens = np.array([[1, 2, 3, 44, 55]], np.int64)
    _assert_close(_logits_ours(params, cfg, tokens), _logits_hf(model, tokens), 4e-3)


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_float32_load_matches_jax(tmp_path, kind):
    """``dtype=torch.float32`` is the weights' dtype alone: the config keeps
    bf16, as JAX's does, and bf16 activations promote against the fp32
    weights in each product as JAX's do, so the two loaders' logits on one
    checkpoint agree to float32 rounding (their float32 sums run in other
    orders)."""
    if kind == "llama":
        hf_cfg, model_cls, extra = _tiny_llama(vocab_size=96, intermediate_size=96, num_hidden_layers=1), \
            transformers.LlamaForCausalLM, {}
    else:
        hf_cfg, model_cls, extra = _tiny_mixtral(), transformers.MixtralForCausalLM, {"capacity_factor": 4.0}
    torch.manual_seed(4)
    model = model_cls(hf_cfg).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    params, cfg = hf.load_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu",
                                        attention_impl="sdpa", **extra)
    jparams, jcfg = jhf.load_hf_checkpoint(str(tmp_path), dtype=jnp.float32, attention_impl="sdpa", **extra)
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert params["layers"][0]["wq"].dtype == torch.float32
    tokens = np.array([[1, 2, 3, 44, 55, 7]], np.int64)
    want = np.asarray(jl.forward(jparams, jnp.asarray(tokens), jcfg), np.float32)
    _assert_close(_logits_ours(params, cfg, tokens), want, 1e-5)


def test_reader_matches_safetensors_load_file(tmp_path):
    """Every tensor of a sharded bf16 Mixtral checkpoint, and of a file of
    every dtype the loader must read, equals safetensors' own load."""
    torch.manual_seed(7)
    model = transformers.MixtralForCausalLM(_tiny_mixtral()).eval().to(torch.bfloat16)
    model.save_pretrained(tmp_path, safe_serialization=True, max_shard_size="100KB")
    files = sorted(tmp_path.glob("*.safetensors"))
    assert len(files) > 1
    tensors = {"f32": torch.randn(3, 5), "f16": torch.randn(7).half(), "i8": torch.arange(-4, 4, dtype=torch.int8),
               "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3), "i64": torch.arange(3),
               "empty": torch.zeros((0, 4)), "bf16": torch.randn(2, 2).bfloat16()}
    safetensors_torch.save_file(tensors, tmp_path / "dtypes.st", metadata={"format": "pt"})
    for f in files + [tmp_path / "dtypes.st"]:
        want = safetensors_torch.load_file(str(f))
        got = hf.read_safetensors(f)
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
            assert torch.equal(got[name], t), name


def test_chip_smoke_checkpoint_loads_in_transformers(tmp_path):
    """The checkpoint writer that ``chip_smoke.py`` uses
    (tests/torch_hf_checkpoint.py; it needs no ``safetensors`` package):
    its files read back equal through safetensors, an
    unaligned tensor through the port's reader too, and its Mixtral
    directory loads in transformers with the port's logits."""
    odd = {"i8": torch.arange(3, dtype=torch.int8), "f32": torch.randn(5), "bf16": torch.randn(2, 3).bfloat16()}
    ckpt.write_safetensors(tmp_path / "odd.safetensors", odd)
    for got in (safetensors_torch.load_file(str(tmp_path / "odd.safetensors")),
                hf.read_safetensors(tmp_path / "odd.safetensors")):
        assert all(torch.equal(got[k], v) for k, v in odd.items())
    cfg = tl.mixtral_8x7b(vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2,
                          num_q_heads=4, num_kv_heads=2, head_dim=16, num_experts=4)
    sd = ckpt.mixtral_hf_state_dict(cfg, torch.Generator().manual_seed(9), device="cpu")
    root = tmp_path / "mixtral"
    root.mkdir()
    ckpt.write_mixtral_checkpoint(str(root), cfg, sd)
    model = transformers.MixtralForCausalLM.from_pretrained(str(root), torch_dtype=torch.float32).eval()
    params, got_cfg = hf.load_hf_checkpoint(str(root), dtype=torch.float32, device="cpu",
                                            attention_impl="sdpa", capacity_factor=4.0)
    assert got_cfg == tl.mixtral_8x7b(**{**cfg.__dict__, "attention_impl": "sdpa", "capacity_factor": 4.0})
    tokens = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    _assert_close(_logits_ours(params, got_cfg, tokens), _logits_hf(model, tokens), 5e-3)


def test_reader_refuses_an_unknown_dtype(tmp_path):
    header = json.dumps({"x": {"dtype": "F4", "shape": [2], "data_offsets": [0, 1]}}).encode()
    (tmp_path / "bad.safetensors").write_bytes(len(header).to_bytes(8, "little") + header + b"\0")
    with pytest.raises(ValueError, match="unknown dtype 'F4'"):
        hf.read_safetensors(tmp_path / "bad.safetensors")


def test_engine_from_hf_checkpoint(tmp_path):
    hf_cfg = _tiny_llama(vocab_size=96, intermediate_size=96, num_hidden_layers=1)
    torch.manual_seed(5)
    transformers.LlamaForCausalLM(hf_cfg).eval().save_pretrained(tmp_path, safe_serialization=True)
    eng = Engine.from_hf(str(tmp_path), num_slots=2, max_len=128, device="cpu")
    req = eng.submit([3, 7, 11], max_new_tokens=4)
    eng.run_to_completion()
    assert len(req.output) == 4 and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="fuse_projections requires quantize_weights"):
        Engine.from_hf(str(tmp_path), fuse_projections=True, device="cpu")
    fused = Engine.from_hf(str(tmp_path), quantize_weights=True, fuse_projections=True,
                           num_slots=2, max_len=128, device="cpu")
    assert tq.is_quantized(fused.params["layers"][0]["w_qkv"])


def test_engine_from_hf_mixtral(tmp_path):
    torch.manual_seed(8)
    transformers.MixtralForCausalLM(_tiny_mixtral()).eval().save_pretrained(tmp_path, safe_serialization=True)
    eng = Engine.from_hf(str(tmp_path), quantize_weights=True, num_slots=2, max_len=128, device="cpu")
    assert tq.is_quantized(eng.params["layers"][1]["moe"]["w_up"])
    reqs = [eng.submit([3, 7, 11], max_new_tokens=4), eng.submit([9, 2], max_new_tokens=3)]
    eng.run_to_completion()
    assert [len(r.output) for r in reqs] == [4, 3]


def test_params_from_hf_rejects_dropped_biases():
    hf_cfg = transformers.Qwen2Config(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                      num_attention_heads=2, num_key_value_heads=1, use_sliding_window=False)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    cfg = hf.config_from_hf(hf_cfg)
    if cfg.qkv_bias:
        pytest.skip("this transformers version exposes a bias flag")
    with pytest.raises(ValueError, match="qkv_bias"):
        hf.params_from_hf(model.state_dict(), cfg, device="cpu")


def _leaf_pairs(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            yield from _leaf_pairs(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            yield from _leaf_pairs(x, y)
    else:
        yield a, b


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
def test_hf_checkpoint_streaming_quantize(tmp_path, arch):
    """quantize_weights quantizes each projection as it is read; the tree
    equals quantizing the full-precision tree after the fact bit for bit
    (the same quantizer on the same values)."""
    torch.manual_seed(6)
    if arch == "llama":
        model = transformers.LlamaForCausalLM(_tiny_llama(vocab_size=96, hidden_size=256, intermediate_size=256,
                                                          num_hidden_layers=1))
    else:
        model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            vocab_size=96, hidden_size=256, intermediate_size=256, num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=4, sliding_window=None))
    model.eval().save_pretrained(tmp_path, safe_serialization=True)
    full, cfg = hf.load_hf_checkpoint(str(tmp_path), device="cpu")
    for mode, post in (("int8", tq.quantize_params), ("int4", tq.quantize_params_int4)):
        streamed, _ = hf.load_hf_checkpoint(str(tmp_path), quantize_weights=mode, device="cpu")
        for a, b in _leaf_pairs(streamed, post(full)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if mode == "int4":
            assert "q4" in streamed["layers"][0]["wq"]
            if arch == "mixtral":
                assert "q" in streamed["layers"][0]["moe"]["w_gate"]  # experts stay int8
            else:
                assert "q4" in streamed["layers"][0]["w_gate"]


def test_params_from_hf_rejects_bad_quantize_mode():
    model = transformers.LlamaForCausalLM(_tiny_llama(intermediate_size=64, num_hidden_layers=1)).eval()
    cfg = hf.config_from_hf(model.config)
    with pytest.raises(ValueError, match="quantize"):
        hf.params_from_hf(model.state_dict(), cfg, quantize="fp4", device="cpu")


def test_config_from_hf_dicts_and_windows():
    """A plain dict (config.json) maps as the object does: Mistral's
    ``sliding_window`` to ``window``, Qwen2's off switch, Mixtral's experts."""
    mistral = {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
               "num_attention_heads": 32, "num_key_value_heads": 8, "rope_theta": 10000.0,
               "sliding_window": 4096, "rms_norm_eps": 1e-5}
    assert hf.config_from_hf(mistral) == tl.mistral_7b(rms_norm_eps=1e-5, rope_theta=10000.0)
    assert hf.config_from_hf(dict(mistral, use_sliding_window=False)).window is None
    mixtral = dict(mistral, sliding_window=None, num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6)
    assert hf.config_from_hf(mixtral) == tl.mixtral_8x7b()
    for d in (mistral, mixtral):
        j = jhf.config_from_hf(d)
        t = hf.config_from_hf(d)
        for field in ("window", "num_experts", "num_experts_per_tok", "head_dim", "rope_theta", "qkv_bias"):
            assert getattr(t, field) == getattr(j, field), field


def test_port_reads_checkpoints_without_transformers_or_safetensors():
    """The port, chip_smoke.py and the tests' helpers it loads import
    neither package (the card's machine has neither)."""
    paths = sorted((ROOT / "quantumattention_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_hf_checkpoint.py", ROOT / "tests" / "torch_fuzz_draws.py"]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("transformers", "safetensors", "jax"), f"{path}: {name}"
