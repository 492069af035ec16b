"""The ``llama`` family: the Llama block as ``models/llama`` runs it (RMSNorm,
GQA attention with RoPE and an optional sliding window, SwiGLU), with
Mixtral's MoE FFN where the published keys count experts under
``num_local_experts``.  Mistral-7B and Mixtral-8x7B are of it.

Its published keys are those of HF's ``LlamaConfig``, ``MistralConfig``
and ``MixtralConfig`` (``FIELDS``); its served tree is ``models/llama``'s
int8 layout (names as there, matrices stored (in, out), an int8 matrix as
``{"q": int8 codes, "s": fp32 scales (..., 1, out)}``, the embedding's
scales per row); its reference is ``perfbench/reference/llama.py``; its
operation and byte counts are ``perfbench/work.py``.
"""

from __future__ import annotations

import math
import types
from typing import Dict

import torch

from perfbench.reference import llama as reference
from perfbench.weights import _int8, _int8_rows, _norm, leaf_generator

#: LlamaConfig field <- published config.json key.
FIELDS = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_layers": "num_hidden_layers",
    "num_q_heads": "num_attention_heads",
    "num_kv_heads": "num_key_value_heads",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_norm_eps",
    "window": "sliding_window",
    "num_experts": "num_local_experts",
    "num_experts_per_tok": "num_experts_per_tok",
}


def preset(model: Dict):
    """The program's ``LlamaConfig`` from the file's ``preset`` and
    ``overrides``, unchecked."""
    from quantumattention_tpu_torch.models import llama

    return getattr(llama, model["preset"])(**model.get("overrides", {}))


def check(cfg, model: Dict) -> None:
    """Raise where ``cfg`` departs from the file's published keys (a file
    without ``num_local_experts`` counts no experts)."""
    hf = model["config"]
    for field, key in FIELDS.items():
        want = hf.get(key, 0 if key == "num_local_experts" else None)
        if field == "num_experts_per_tok" and not hf.get("num_local_experts"):
            continue
        got = getattr(cfg, field)
        if (got != want) if not isinstance(got, float) else abs(got - float(want)) > 1e-12:
            raise ValueError(f"{model['preset']}: {field} = {got}, the configuration says {key} = {want}")
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    if cfg.head_dim != head_dim or cfg.tie_embeddings != bool(hf.get("tie_word_embeddings", False)):
        raise ValueError(f"{model['preset']}: head_dim or tied embeddings differ from the configuration")


def program_config(model: Dict):
    cfg = preset(model)
    check(cfg, model)
    return cfg


def sizes(model: Dict):
    s = reference.shape_of(model["config"])
    return types.SimpleNamespace(
        hidden_size=s.hidden, intermediate_size=s.inter, num_layers=s.layers, num_q_heads=s.q_heads,
        num_kv_heads=s.kv_heads, head_dim=s.head_dim, vocab_size=s.vocab, num_experts=s.experts)


def layer_shapes(cfg) -> Dict[str, tuple]:
    h, i = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_q_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h)}
    if cfg.num_experts:
        e = cfg.num_experts
        shapes.update({"moe.w_gate": (e, h, i), "moe.w_up": (e, h, i), "moe.w_down": (e, i, h)})
    else:
        shapes.update({"w_gate": (h, i), "w_up": (h, i), "w_down": (i, h)})
    return shapes


def int8_layer(cfg, idx: int, seed: int, device) -> Dict:
    """Decoder layer ``idx`` of an int8 tree; an MoE router is fp32,
    normal over sqrt(hidden)."""
    pre = f"layers.{idx}."
    h = cfg.hidden_size
    layer = {"attn_norm": _norm(h, pre + "attn_norm", seed, device),
             "mlp_norm": _norm(h, pre + "mlp_norm", seed, device)}
    moe = {}
    for name, shape in layer_shapes(cfg).items():
        w = _int8(shape, pre + name, seed, device)
        if name.startswith("moe."):
            moe[name[4:]] = w
        else:
            layer[name] = w
    if moe:
        g = leaf_generator(seed, pre + "moe.w_router", device)
        router = torch.randn((h, cfg.num_experts), generator=g, device=device)
        moe["w_router"] = router.mul_(1.0 / math.sqrt(h))
        layer["moe"] = {k: moe[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    return layer


def int8_top(cfg, seed: int, device) -> Dict:
    """The embedding, final norm and LM head of an int8 tree."""
    return {
        "embed": _int8_rows((cfg.vocab_size, cfg.hidden_size), "embed", seed, device),
        "final_norm": _norm(cfg.hidden_size, "final_norm", seed, device),
        "lm_head": _int8((cfg.hidden_size, cfg.vocab_size), "lm_head", seed, device),
    }


def int8_tree(cfg, seed: int, device) -> Dict:
    tree = int8_top(cfg, seed, device)
    tree["layers"] = [int8_layer(cfg, i, seed, device) for i in range(cfg.num_layers)]
    return tree
