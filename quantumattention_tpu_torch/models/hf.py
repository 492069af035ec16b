"""Hugging Face checkpoints for the Llama-family decoder (counterpart of
quantumattention_tpu/models/hf.py).

Maps ``transformers`` Llama, Qwen2, Mistral and Mixtral checkpoints onto
``models/llama.py``'s parameter tree: renaming and transposes only, since
the decoder follows HF's conventions (rotate-half RoPE, blockwise GQA head
grouping, ``sliding_window`` = w keys including self).  Weights come in as
a state dict (torch tensors or numpy arrays) with the HF config (an object
or a plain dict); nothing here imports ``transformers``.

``load_hf_checkpoint`` reads a checkpoint directory (``config.json`` and
every ``*.safetensors`` file, sharded or single) with the reader of this
module, :func:`read_safetensors`, which maps each file and wraps its
tensors without copying; the ``safetensors`` package is not needed.
With ``quantize`` each projection is converted and quantized on the target
device as it is read, so one full-precision matrix is live there at a time
(at Mixtral's widths one expert: 0.12 GB bf16); the result is bit for bit
the tree quantized after the fact.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import pathlib
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..utils import checks
from .llama import LlamaConfig, Params

#: safetensors dtype names -> torch dtypes.
_ST_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    private (copy-on-write) map of the file.  The format: an 8-byte
    little-endian header length, a JSON header (per tensor ``dtype``,
    ``shape`` and ``data_offsets`` relative to the data; an optional
    ``__metadata__``), then the raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {info['dtype']!r}")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = (end - begin) // dtype.itemsize
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes for shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % dtype.itemsize:  # unaligned: copy the bytes
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=base + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin).reshape(shape)
    return out


def _has_qkv_bias(sd: Mapping[str, Any]) -> bool:
    """Does the state dict carry q/k/v projection biases?  (Qwen2 ships
    them with no config flag.)"""
    return any(k.endswith("self_attn.q_proj.bias") for k in sd)


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """Map a transformers config (Llama/Qwen2/Mistral/Mixtral), an object
    or a plain dict, onto :class:`LlamaConfig`."""
    get = (
        hf_config.get
        if isinstance(hf_config, Mapping)
        else lambda k, d=None: getattr(hf_config, k, d)
    )
    hidden = get("hidden_size")
    heads = get("num_attention_heads")
    cfg = LlamaConfig(
        vocab_size=get("vocab_size"),
        hidden_size=hidden,
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads),
        head_dim=get("head_dim") or hidden // heads,
        rope_theta=float(get("rope_theta", 10000.0)),
        rms_norm_eps=float(get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        qkv_bias=bool(get("attention_bias", False) or get("qkv_bias", False)),
        window=get("sliding_window", None) if get("use_sliding_window", True) else None,
        num_experts=get("num_local_experts", 0) or 0,
        num_experts_per_tok=get("num_experts_per_tok", 2) or 2,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def params_from_hf(
    state_dict: Mapping[str, Any], cfg: LlamaConfig, dtype=None, quantize=False, device=None,
) -> Params:
    """Convert an HF Llama-family state dict to this package's tree on
    ``device`` (the CUDA card unless it says otherwise).

    HF linear weights are (out, in) and the tree stores (in, out), so every
    projection transposes; norms stay fp32.  Each value goes to ``device``,
    through fp32 to ``dtype`` (cfg.dtype by default), as the JAX loader
    casts.  ``quantize`` (False, True/"int8" or "int4") quantizes each
    projection there as soon as it is converted; the LM head and MoE expert
    stacks stay int8 under "int4", as in ``quantized.quantize_params_int4``.
    An expert stack is quantized one expert at a time (per-expert scales,
    so the values equal quantizing the whole stack)."""
    from . import quantized as qz

    if quantize not in (False, True, "int8", "int4"):
        raise ValueError(f"quantize must be False/True/'int8'/'int4', got {quantize!r}")
    qmode = {False: None, True: "int8", "int8": "int8", "int4": "int4"}[quantize]
    device = checks.default_device(device)
    dtype = dtype or cfg.dtype
    sd = state_dict
    if not cfg.qkv_bias and _has_qkv_bias(sd):
        # Qwen2 carries q/k/v biases with no config flag: a config without
        # qkv_bias would drop them and serve wrong logits.
        raise ValueError(
            "checkpoint has q/k/v projection biases but cfg.qkv_bias is "
            "False — build the config with config_from_hf(..., "
            "qkv_bias=True) or use load_hf_model/load_hf_checkpoint"
        )

    def tensor(name, dt):
        return torch.as_tensor(sd[name]).to(device).float().to(dt)

    def proj(name):  # transposed (in, out) in the compute dtype
        return tensor(name, torch.float32).t().contiguous().to(dtype)

    def w(name):
        arr = proj(name)
        if qmode == "int4" and arr.shape[0] % 256 == 0:
            return qz.quantize_matrix_int4(arr)
        return qz.quantize_matrix(arr) if qmode else arr

    def w8(name):
        return qz.quantize_matrix(proj(name)) if qmode else proj(name)

    def key(name):
        # lm_head lives at the top level, everything else under "model."
        return name if name in sd else "model." + name

    embed = tensor(key("embed_tokens.weight"), dtype)
    params: Params = {
        "embed": qz.quantize_embed(embed) if qmode else embed,
        "final_norm": tensor(key("norm.weight"), torch.float32),
        "layers": [],
    }
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = w8(key("lm_head.weight"))

    for i in range(cfg.num_layers):
        p = key(f"layers.{i}")
        layer: Dict[str, Any] = {
            "attn_norm": tensor(f"{p}.input_layernorm.weight", torch.float32),
            "mlp_norm": tensor(f"{p}.post_attention_layernorm.weight", torch.float32),
            "wq": w(f"{p}.self_attn.q_proj.weight"),
            "wk": w(f"{p}.self_attn.k_proj.weight"),
            "wv": w(f"{p}.self_attn.v_proj.weight"),
            "wo": w(f"{p}.self_attn.o_proj.weight"),
        }
        if cfg.qkv_bias:
            layer["bq"] = tensor(f"{p}.self_attn.q_proj.bias", dtype)
            layer["bk"] = tensor(f"{p}.self_attn.k_proj.bias", dtype)
            layer["bv"] = tensor(f"{p}.self_attn.v_proj.bias", dtype)
        if cfg.num_experts > 0:
            # Mixtral: w1 = gate, w3 = up, w2 = down; the router stays fp32.
            moe = f"{p}.block_sparse_moe"

            def stack(hf_key):
                names = [f"{moe}.experts.{j}.{hf_key}.weight" for j in range(cfg.num_experts)]
                if not qmode:
                    return torch.stack([proj(n) for n in names])
                parts = [qz.quantize_matrix(proj(n)) for n in names]
                return {k: torch.stack([part[k] for part in parts]) for k in ("q", "s")}

            layer["moe"] = {
                "w_router": tensor(f"{moe}.gate.weight", torch.float32).t().contiguous(),
                "w_gate": stack("w1"),
                "w_up": stack("w3"),
                "w_down": stack("w2"),
            }
        else:
            layer["w_gate"] = w(f"{p}.mlp.gate_proj.weight")
            layer["w_up"] = w(f"{p}.mlp.up_proj.weight")
            layer["w_down"] = w(f"{p}.mlp.down_proj.weight")
        params["layers"].append(layer)
    return params


def _cfg_with_detected_bias(cfg: LlamaConfig, sd: Mapping[str, Any]) -> LlamaConfig:
    """The state dict decides q/k/v biases (Qwen2 carries them with no
    config flag)."""
    if not cfg.qkv_bias and _has_qkv_bias(sd):
        return dataclasses.replace(cfg, qkv_bias=True)
    return cfg


def load_hf_model(model: Any, dtype=None, device=None) -> tuple:
    """(params, cfg) from an in-memory transformers model instance."""
    sd = model.state_dict()
    cfg = _cfg_with_detected_bias(config_from_hf(model.config), sd)
    return params_from_hf(sd, cfg, dtype=dtype, device=device), cfg


def load_hf_checkpoint(path, dtype=None, quantize_weights=False, device=None, **config_overrides) -> tuple:
    """(params, cfg) from an HF checkpoint directory (``config.json`` and
    ``*.safetensors``, sharded or single-file), read by
    :func:`read_safetensors`.  ``quantize_weights`` is ``params_from_hf``'s
    ``quantize``: False, True/"int8" (w8a16) or "int4" (w4a16 decoder
    projections).  A ``dtype`` given is the weights' alone: the config
    keeps its own, and a product of the two promotes, as in JAX."""
    root = pathlib.Path(path)
    hf_config = json.loads((root / "config.json").read_text())
    cfg = config_from_hf(hf_config, **config_overrides)
    files = sorted(root.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    cfg = _cfg_with_detected_bias(cfg, sd)
    params = params_from_hf(sd, cfg, dtype=dtype, quantize=quantize_weights, device=device)
    return params, cfg
