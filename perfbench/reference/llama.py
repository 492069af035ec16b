"""Plain float32 reference of the served models: Mistral-7B (Llama block,
sliding window) and Mixtral-8x7B (its MoE FFN), read from the published
``config.json`` keys the configuration file holds.

It follows the published model: RMSNorm, rotate-half RoPE at theta, GQA
attention under the causal mask cut to ``sliding_window`` keys (the row
itself included), SwiGLU, and Mixtral's router (softmax over the top-k
logits of an fp32 product) with every routed token computed (no capacity:
the published model drops nothing).  All of it in float32 with TF32 off,
over exact keys and values (no cache, no quantization of activations).

The weights are the benchmark's: the int8 codes and scales drawn from the
seed (``perfbench/weights.py``), drawn again here a layer at a time and
multiplied out in float32.  ``variants`` put other weights in their place
(the control: every product's matrix rounded to int4).  Imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: Query rows a block when the reference attends (bounds the score matrix).
ATTN_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Shape:
    hidden: int
    inter: int
    layers: int
    q_heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    theta: float
    eps: float
    window: Optional[int]
    experts: int
    top_k: int


def shape_of(hf: Dict) -> Shape:
    """The sizes the reference needs, from HF ``config.json`` keys."""
    heads = hf["num_attention_heads"]
    return Shape(
        hidden=hf["hidden_size"], inter=hf["intermediate_size"], layers=hf["num_hidden_layers"],
        q_heads=heads, kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads, vocab=hf["vocab_size"],
        theta=float(hf["rope_theta"]), eps=float(hf["rms_norm_eps"]), window=hf.get("sliding_window"),
        experts=hf.get("num_local_experts", 0), top_k=hf.get("num_experts_per_tok", 0),
    )


def int4_roundtrip(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """(..., in, out) float32 rounded to symmetric int4 codes in groups of
    ``group`` input rows a column, and multiplied back out."""
    *lead, n_in, n_out = w.shape
    g = w.reshape(*lead, n_in // group, group, n_out)
    s = g.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(g / s).clamp_(-7, 7) * s).reshape(w.shape)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (H, S, D) at positions 0..S-1, rotate-half convention."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Causal (windowed) attention of (Hq, S, D) queries over (Hkv, S, D)
    keys and values, in blocks of query rows.  Returns (S, Hq * D)."""
    hq, s, d = q.shape
    group = hq // k.shape[0]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    cols = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for r0 in range(0, s, ATTN_BLOCK):
        rows = torch.arange(r0, min(s, r0 + ATTN_BLOCK), device=q.device)
        lo = 0 if window is None else max(0, r0 + 1 - window)
        hi = int(rows[-1]) + 1
        scores = q[:, rows] @ k[:, lo:hi].transpose(1, 2) / math.sqrt(d)
        c = cols[lo:hi]
        keep = c[None, :] <= rows[:, None]
        if window is not None:
            keep &= c[None, :] > rows[:, None] - window
        scores = scores.masked_fill(~keep, float("-inf"))
        out[:, rows] = torch.softmax(scores, dim=-1) @ v[:, lo:hi]
    return out.transpose(0, 1).reshape(s, hq * d)


def mlp(x: torch.Tensor, w: Dict[str, torch.Tensor], shape: Shape) -> torch.Tensor:
    if not shape.experts:
        return (F.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]
    logits = x @ w["w_router"]
    top, idx = torch.topk(logits, shape.top_k, dim=-1)
    gates = torch.softmax(top.float(), dim=-1).to(x.dtype)
    y = torch.zeros_like(x)
    for e in range(shape.experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        out = (F.silu(h @ w["w_gate"][e]) * (h @ w["w_up"][e])) @ w["w_down"][e]
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], shape: Shape) -> torch.Tensor:
    """One decoder layer over one sequence's (S, H) activations."""
    s = x.shape[0]
    h = rms_norm(x, w["attn_norm"], shape.eps)
    q = (h @ w["wq"]).reshape(s, shape.q_heads, shape.head_dim).transpose(0, 1)
    k = (h @ w["wk"]).reshape(s, shape.kv_heads, shape.head_dim).transpose(0, 1)
    v = (h @ w["wv"]).reshape(s, shape.kv_heads, shape.head_dim).transpose(0, 1)
    a = attend(rope(q, shape.theta), rope(k, shape.theta), v, shape.window)
    x = x + a @ w["wo"]
    return x + mlp(rms_norm(x, w["mlp_norm"], shape.eps), w, shape)


def _dense(tree_layer: Dict, transform: Callable) -> Dict[str, torch.Tensor]:
    """A drawn int8 layer as float32 matrices; ``transform`` applies to
    every product's matrix (not to norms or the fp32 router)."""
    out = {}
    for name, leaf in tree_layer.items():
        if name == "moe":
            for k, v in leaf.items():
                out[k] = v.float() if k == "w_router" else transform(v["q"].float() * v["s"])
        elif isinstance(leaf, dict):
            out[name] = transform(leaf["q"].float() * leaf["s"])
        else:
            out[name] = leaf.float()
    return out


def logits_at(
    shape: Shape,
    sequences: Sequence[Sequence[int]],
    positions: Sequence[Sequence[int]],
    top: Dict,
    layer_fn: Callable[[int], Dict],
    variants: Optional[Dict[str, Callable]] = None,
) -> Dict[str, List[torch.Tensor]]:
    """Float32 logits at ``positions[i]`` of each sequence, for each weight
    variant (``{"ref": identity}`` by default; a variant given as
    ``(transform, dtype)`` also computes in ``dtype``).  ``top``: the int8
    tree's embed, final_norm and lm_head; ``layer_fn(i)``: its layer i,
    drawn again for each call.  Runs layer by layer over every sequence."""
    variants = {name: v if isinstance(v, tuple) else (v, torch.float32)
                for name, v in (variants or {"ref": lambda w: w}).items()}
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            embed = top["embed"]
            xs0 = []
            for seq in sequences:
                ids = torch.as_tensor(list(seq), dtype=torch.int64, device=embed["q"].device)
                xs0.append(embed["q"][ids].float() * embed["s"][ids])
            xs = {name: [x.to(dt) for x in xs0] for name, (_, dt) in variants.items()}
            for i in range(shape.layers):
                drawn = layer_fn(i)
                for name, (transform, dt) in variants.items():
                    w = {k: v.to(dt) for k, v in _dense(drawn, transform).items()}
                    xs[name] = [layer(x, w, shape) for x in xs[name]]
                    del w
                del drawn
            out = {}
            for name, (transform, dt) in variants.items():
                head = transform(top["lm_head"]["q"].float() * top["lm_head"]["s"]).to(dt)
                norm = top["final_norm"].to(dt)
                out[name] = [
                    (rms_norm(x[torch.as_tensor(list(p), device=x.device)], norm, shape.eps) @ head).float()
                    for x, p in zip(xs[name], positions)
                ]
            return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def served_gaps(ref: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """Per position, how far the served token's logit lies below the
    reference's best (0 where the served token is the reference's argmax)."""
    tok = torch.as_tensor(list(served), dtype=torch.int64, device=ref.device)
    return ref.max(dim=-1).values - ref.gather(-1, tok[:, None])[:, 0]


def chosen_gaps(ref: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Per position, the reference's gap of the token ``other`` puts first."""
    return served_gaps(ref, other.argmax(dim=-1).tolist())
