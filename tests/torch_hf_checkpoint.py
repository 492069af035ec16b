"""A Mixtral checkpoint directory written from seeded tensors, without
the ``safetensors`` or ``transformers`` packages: ``config.json`` as
transformers' ``MixtralConfig`` spells it and one ``model.safetensors`` in
its key names.  Shared by the CPU tests (tests/test_torch_hf.py), the card
tests (tests/test_torch_cuda.py) and ``chip_smoke.py``'s ``from_hf``
check, which loads this file by path.
"""

import json
import math
import os
import struct

import torch

#: torch dtypes -> safetensors dtype names, for :func:`write_safetensors`.
ST_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
            torch.int8: "I8", torch.int32: "I32", torch.int64: "I64"}


def write_safetensors(path, tensors: dict) -> None:
    """One ``.safetensors`` file, in the format ``models/hf.read_safetensors``
    reads (an 8-byte little-endian header length, a JSON header padded to 8
    bytes, the raw little-endian bytes), written without the
    ``safetensors`` package, so that ``chip_smoke.py`` needs only PyTorch
    and numpy."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())


def mixtral_hf_config(cfg) -> dict:
    """``config.json`` of a Mixtral checkpoint as transformers'
    ``MixtralConfig`` spells it."""
    return {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_q_heads, "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "hidden_act": "silu", "max_position_embeddings": 32768,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta, "sliding_window": None,
            "num_local_experts": cfg.num_experts, "num_experts_per_tok": cfg.num_experts_per_tok,
            "router_aux_loss_coef": 0.02, "output_router_logits": False, "tie_word_embeddings": False,
            "attention_dropout": 0.0, "initializer_range": 0.02, "bos_token_id": 1, "eos_token_id": 2,
            "torch_dtype": "bfloat16", "use_cache": True}


def mixtral_hf_state_dict(cfg, gen, device="cuda") -> dict:
    """A Mixtral state dict in transformers' key names and (out, in)
    layouts, seeded bf16 (normal over sqrt(fan_in); norms near 1), drawn on
    ``device`` and returned on the CPU."""
    def draw(shape, fan_in=None):
        t = torch.randn(shape, generator=gen, device=device)
        t = t / math.sqrt(fan_in) if fan_in else 1.0 + 0.1 * t
        return t.to(torch.bfloat16).cpu()

    e, f, q, kv = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    sd = {"model.embed_tokens.weight": draw((cfg.vocab_size, e), e), "model.norm.weight": draw((e,)),
          "lm_head.weight": draw((cfg.vocab_size, e), e)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        sd.update({f"{p}.input_layernorm.weight": draw((e,)),
                   f"{p}.post_attention_layernorm.weight": draw((e,)),
                   f"{p}.self_attn.q_proj.weight": draw((q, e), e),
                   f"{p}.self_attn.k_proj.weight": draw((kv, e), e),
                   f"{p}.self_attn.v_proj.weight": draw((kv, e), e),
                   f"{p}.self_attn.o_proj.weight": draw((e, q), q),
                   f"{p}.block_sparse_moe.gate.weight": draw((cfg.num_experts, e), e)})
        for j in range(cfg.num_experts):
            x = f"{p}.block_sparse_moe.experts.{j}"
            sd.update({f"{x}.w1.weight": draw((f, e), e), f"{x}.w3.weight": draw((f, e), e),
                       f"{x}.w2.weight": draw((e, f), f)})
    return sd


def write_mixtral_checkpoint(root, cfg, sd) -> None:
    """A checkpoint directory: ``config.json`` and one ``model.safetensors``."""
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(mixtral_hf_config(cfg), f)
    write_safetensors(os.path.join(root, "model.safetensors"), sd)


def tree_pairs(a, b):
    """The leaves of two trees of dicts and lists side by side; the trees
    must hold the same keys and list lengths."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise RuntimeError(f"trees differ in keys: {sorted(a)} vs {sorted(b)}")
        for k in a:
            yield from tree_pairs(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b, strict=True):
            yield from tree_pairs(x, y)
    else:
        yield a, b
