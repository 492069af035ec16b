"""Weights drawn from the seed, on the device, in the form they are served.

Every leaf has a generator of its own, seeded from the run's seed and the
leaf's name, so the reference can draw any one leaf again, alone and in the
same bytes, after the program's state is freed.  Nothing here imports the
program: the trees are plain dicts in the port's layout (``models/llama``'s
names, matrices stored (in, out), an int8 matrix as ``{"q": int8 codes,
"s": fp32 scales (..., 1, out)}``, the embedding's scales per row).

int8 trees are drawn as codes and scales directly (a bf16 Mixtral does not
fit the card): codes uniform in [-127, 127], each output column's scale
1 / (73.6 * sqrt(fan_in)) times a factor uniform in [0.5, 1.5], so the
weights have about the variance of a 1 / sqrt(fan_in) init and every
column its own scale.  RMSNorm weights are 1 + U(-0.1, 0.1); an MoE router
is fp32, normal over sqrt(hidden).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import torch

#: Standard deviation of codes uniform on the 255 integers [-127, 127].
CODE_STD = math.sqrt((255 ** 2 - 1) / 12.0)


def leaf_generator(seed: int, name: str, device) -> torch.Generator:
    mixed = (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _int8(shape, name: str, seed: int, device) -> Dict[str, torch.Tensor]:
    g = leaf_generator(seed, name, device)
    q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
    scale_shape = (*shape[:-2], 1, shape[-1])
    s = torch.rand(scale_shape, generator=g, device=device).add_(0.5)
    s.mul_(1.0 / (CODE_STD * math.sqrt(shape[-2])))
    return {"q": q, "s": s}


def _int8_rows(shape, name: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """An embedding table quantized per row: (V, H) codes, (V, 1) scales."""
    g = leaf_generator(seed, name, device)
    q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
    s = torch.rand((shape[0], 1), generator=g, device=device).add_(0.5)
    s.mul_(1.0 / (CODE_STD * math.sqrt(shape[0])))
    return {"q": q, "s": s}


def _norm(n: int, name: str, seed: int, device) -> torch.Tensor:
    g = leaf_generator(seed, name, device)
    return torch.rand((n,), generator=g, device=device).mul_(0.2).add_(0.9)


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
    """Decoder layer ``idx`` of an int8 tree."""
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
