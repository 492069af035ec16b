"""Llama-family decoder on the fused attention engine (counterpart of
quantumattention_tpu/models/llama.py).

RMSNorm -> GQA attention with RoPE -> SwiGLU MLP, with attention served by
``fp8_attn_func_with_fallback`` (the default ``attention_impl="fp8"``),
``attn_func_with_fallback`` ("bf16") or the SDPA reference ("sdpa").
Parameters are a plain dict with the JAX package's names and layouts:
every weight is stored (in, out), "transposed-for-einsum", so
``models/convert.params_from_numpy`` maps a JAX tree onto it one to one.

``forward`` is differentiable: ``loss_fn`` and ``train_step`` (plain SGD)
train through it, with attention gradients from the backward kernels K2/K3
(ops/flash_bwd.py).  ``forward_prefill``, ``forward_chunk`` (chunked
prefill) and ``forward_decode`` serve and run without autograd.

Quantized trees (``models/quantized``: w8a16/w4a16 leaves, optionally
fused into ``w_qkv``/``w_gate_up``) serve through the weight kernels
K5/K6/K7 (ops/qmm.py); on a fused quantized tree each layer tail of at
most 256 rows is kernel K8 (ops/qmlp.py), which also emits the next
layer's QKV, and ``forward_decode`` takes the lean T=1 decode path
(llama.py:573-637 of the JAX package).  ``LlamaConfig.window`` is a
sliding window in HF's convention (``window = w``: each query sees w keys,
itself included, the left extent w - 1; JAX llama.py:283-299), as Mistral
has it (:func:`mistral_7b`).  ``LlamaConfig.num_experts`` > 0 replaces
every MLP with a Mixtral-style MoE FFN (``models/moe.moe_ffn``, :func:`
mixtral_8x7b`); such a layer always takes the unfused path, as in JAX (the
lean decode, K8 and K9 refuse MoE).

Tensor parallelism (``tp``, a ``parallel/mesh.Axis``; ``serving/tp.py``):
each rank holds its Megatron slices of the tree (``parallel/mesh.
param_specs_for``) and runs the same code on its local heads and columns
(:func:`local_config`); the collectives GSPMD inserts in JAX are written
out: one all-reduce after each row-split product (wo, w_down, an MoE FFN
over column-split experts), a vocab-parallel embedding lookup (rows outside
the rank's slice masked, then an all-reduce), and a column-parallel LM head
whose logits are all-gathered.  Without ``tp`` nothing changes.

Training under a mesh (``mesh=`` on :func:`forward`, :func:`loss_fn`,
:func:`loss_and_grads` and :func:`train_step`; axes ("dp", "tp"), JAX's
``train_step`` jitted over a GSPMD mesh): each rank holds its shards and
its rows of the batch.  The collectives above are Megatron's autograd
pairs (``parallel/mesh.Axis``): the all-reduces ("g") pass the gradient
through, the gathered head hands each rank its slice of it, and an "f" op
(identity forward, all-reduce backward) sits at the input of every
column-parallel product, so partial input gradients are summed over tp.
The loss is the whole batch's mean and every gradient is summed over dp,
so one step equals the single-device step on the whole batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import interface
from ..ops import qmlp
from . import quantized

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: "fp8" routes attention through fp8_attn_func_with_fallback (dynamic
    #: quantization at ``scaling_method``: "head-wise", "token-wise",
    #: "per-block" or "auto"), "bf16" through attn_func_with_fallback,
    #: "sdpa" forces the reference path.  Chunked prefill runs bf16 K1
    #: except under "per-block" and "auto" (``backends.chunk_per_block``).
    attention_impl: str = "fp8"
    scaling_method: str = "head-wise"
    #: Sliding window (HF's ``sliding_window``): each query sees the last
    #: ``window`` keys, itself included; None for full causal attention.
    window: Optional[int] = None
    tie_embeddings: bool = False
    qkv_bias: bool = False
    #: Mixture-of-Experts FFN (Mixtral style): 0 = dense SwiGLU; > 0
    #: replaces every MLP with ``models/moe.moe_ffn`` over this many
    #: experts (top-``num_experts_per_tok`` routing, capacity dropping).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1 keys or None, got {self.window}")

    @property
    def q_dim(self) -> int:
        return self.num_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def llama3_8b(**overrides) -> LlamaConfig:
    """Llama-3-8B's published shapes."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
        ),
        **overrides,
    )


def llama3_70b(**overrides) -> LlamaConfig:
    """Llama-3-70B's published shapes (``meta-llama/Meta-Llama-3-70B``)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_q_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
        ),
        **overrides,
    )


def mistral_7b(**overrides) -> LlamaConfig:
    """Mistral-7B's published shapes (``mistralai/Mistral-7B-v0.1``): the
    Llama block with a 4096-token sliding window."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=10000.0,
            window=4096,
        ),
        **overrides,
    )


def qwen2_7b(**overrides) -> LlamaConfig:
    """Qwen2-7B's published shapes (``Qwen/Qwen2-7B``): the Llama block with
    biases on the Q, K and V projections."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_layers=28,
            num_q_heads=28,
            num_kv_heads=4,
            head_dim=128,
            rope_theta=1000000.0,
            qkv_bias=True,
        ),
        **overrides,
    )


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-8x7B's published shapes (``mistralai/Mixtral-8x7B-v0.1``):
    the Mistral block with 8 SwiGLU experts a layer, top-2 routing, and no
    sliding window."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_q_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
            num_experts=8,
            num_experts_per_tok=2,
        ),
        **overrides,
    )


def tiny(**overrides) -> LlamaConfig:
    """Small config for tests (the JAX package's ``tiny``)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=256,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_q_heads=8,
            num_kv_heads=4,
            head_dim=64,
            rope_theta=10000.0,
        ),
        **overrides,
    )


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(
    generator: torch.Generator, cfg: LlamaConfig, device=None, *,
    transform: Optional[Callable[[str, torch.Tensor], Any]] = None,
) -> Params:
    """Truncated-normal init in [-3, 3], scaled 1/sqrt(fan_in), stored in
    cfg.dtype, drawn from ``generator`` on ``device`` (the generator's
    device by default).  One fp32 matrix is live at a time.
    ``transform(name, w)`` replaces each matrix as soon as it is drawn
    (``quantized.init_quantized_params`` quantizes it there); an MoE
    layer's expert stacks come as ``"moe.w_gate"`` etc.  (the router,
    fp32, is not transformed)."""
    device = torch.device(device if device is not None else generator.device)

    def dense(shape, name):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        w = w.div_(math.sqrt(shape[0])).to(cfg.dtype)
        return transform(name, w) if transform is not None else w

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    params: Params = {
        "embed": dense((cfg.vocab_size, cfg.hidden_size), "embed"),
        "final_norm": ones(cfg.hidden_size),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.hidden_size, cfg.vocab_size), "lm_head")
    for _ in range(cfg.num_layers):
        layer: Params = {}
        if cfg.qkv_bias:
            layer.update(
                bq=torch.zeros((cfg.q_dim,), dtype=cfg.dtype, device=device),
                bk=torch.zeros((cfg.kv_dim,), dtype=cfg.dtype, device=device),
                bv=torch.zeros((cfg.kv_dim,), dtype=cfg.dtype, device=device),
            )
        layer.update(
            attn_norm=ones(cfg.hidden_size),
            wq=dense((cfg.hidden_size, cfg.q_dim), "wq"),
            wk=dense((cfg.hidden_size, cfg.kv_dim), "wk"),
            wv=dense((cfg.hidden_size, cfg.kv_dim), "wv"),
            wo=dense((cfg.q_dim, cfg.hidden_size), "wo"),
            mlp_norm=ones(cfg.hidden_size),
        )
        if cfg.num_experts > 0:
            from . import moe

            layer["moe"] = moe.init_moe_params(
                generator, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                dtype=cfg.dtype, device=device,
                transform=None if transform is None else lambda n, w: transform("moe." + n, w),
            )
        else:
            layer.update(
                w_gate=dense((cfg.hidden_size, cfg.intermediate_size), "w_gate"),
                w_up=dense((cfg.hidden_size, cfg.intermediate_size), "w_up"),
                w_down=dense((cfg.intermediate_size, cfg.hidden_size), "w_down"),
            )
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S) int positions -> cos/sin tables of shape (..., S, head_dim//2)."""
    exponent = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device
    ) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, D) by per-position cos/sin ((B, S, D/2) or (S, D/2)),
    split-halves convention (rotate_half), as HF Llama."""
    if cos.ndim == 2:
        cos_b, sin_b = cos[None, None], sin[None, None]
    else:
        cos_b, sin_b = cos[:, None], sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat((x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b), dim=-1)
    return out.to(x.dtype)


def local_config(cfg: LlamaConfig, n: int) -> LlamaConfig:
    """The shapes one rank of an ``n``-way tensor-parallel split computes:
    its Q and KV heads and its intermediate columns."""
    return dataclasses.replace(
        cfg, num_q_heads=cfg.num_q_heads // n, num_kv_heads=cfg.num_kv_heads // n,
        intermediate_size=cfg.intermediate_size // n,
    )


def window_of(cfg: LlamaConfig) -> Optional[Tuple[int, int]]:
    """The attention window of a config: ``(window - 1, 0)`` (HF's
    ``sliding_window = w`` sees w keys including itself), or None."""
    return (cfg.window - 1, 0) if cfg.window is not None else None


def _attend(cfg: LlamaConfig, q, k, v, *, is_causal: bool):
    window = window_of(cfg)
    if cfg.attention_impl == "fp8":
        return interface.fp8_attn_func_with_fallback(
            q, k, v, is_causal=is_causal, scaling_method=cfg.scaling_method, window=window
        )
    if cfg.attention_impl == "bf16":
        return interface.attn_func_with_fallback(q, k, v, is_causal=is_causal, window=window)
    if cfg.attention_impl == "sdpa":
        from ..dispatch import sdpa_fallback

        return sdpa_fallback(q, k, v, is_causal=is_causal, window=window)
    raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")


def _split_qkv(cfg: LlamaConfig, layer: Params, qkv: torch.Tensor):
    """Split a fused [q|k|v] projection and add the biases."""
    q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    if cfg.qkv_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q, k, v


def _qkv_proj(cfg: LlamaConfig, layer: Params, h: torch.Tensor):
    """Q/K/V projections with optional biases; a tree fused by
    ``quantized.fuse_projections`` takes one ``w_qkv`` product."""
    if "w_qkv" in layer:
        return _split_qkv(cfg, layer, quantized.matmul(h, layer["w_qkv"]))
    q = quantized.matmul(h, layer["wq"])
    k = quantized.matmul(h, layer["wk"])
    v = quantized.matmul(h, layer["wv"])
    if cfg.qkv_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q, k, v


def _layer_attention(cfg, idx, layer, x, cos, sin, attend_fn, qkv=None, tp=None):
    """norm -> QKV -> RoPE -> ``attend_fn(idx, q, k, v)`` on (B, H, T, D).
    Returns (attn_out (B, T, q_dim) before wo, post-RoPE k, v).  ``qkv``:
    this layer's bias-free fused QKV projection, already computed by the
    previous layer's tail kernel (norm and product are skipped).  Under
    ``tp`` the normed input passes the "f" op (:func:`_column_input`)."""
    batch, t, _ = x.shape
    if qkv is not None:
        q, k, v = _split_qkv(cfg, layer, qkv)
    else:
        h = _column_input(rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps), tp)
        q, k, v = _qkv_proj(cfg, layer, h)
    q = q.reshape(batch, t, cfg.num_q_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(batch, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(batch, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = attend_fn(idx, q, k, v)
    out = out.to(x.dtype).transpose(1, 2).reshape(batch, t, cfg.q_dim)
    return out, k, v


def attention_block(cfg: LlamaConfig, layer: Params, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Self-attention sublayer over (B, S, E) activations (the fused
    kernel, causal) plus the residual."""
    attn_out, _, _ = _layer_attention(cfg, 0, layer, x, cos, sin, _fused_attend(cfg))
    return x + quantized.matmul(attn_out, layer["wo"])


def _layer_tail(cfg: LlamaConfig, layer: Params, x, attn_out, next_layer=None, tp=None, dp=None):
    """Output projection + residual + MLP.  Returns (new x, the next
    layer's bias-free QKV or None).  Under ``tp`` the row-split products'
    partial sums are all-reduced (a fused tree, which K8 needs, cannot be
    sharded); ``dp`` reaches an MoE FFN (:func:`mlp_block`).

    On a fused quantized tree at <= 256 rows this is one call of kernel
    K8 (ops/qmlp.fused_layer_tail), which also emits ``next_layer``'s
    attn-norm + QKV product when that layer has a fused ``w_qkv``;
    elsewhere (bf16 or unfused trees, larger prefill groups,
    ``kernel.qmlp`` off) the unfused path runs."""
    if qmlp.tail_supported(cfg, layer, x):
        lead = x.shape[:-1]
        fold = qmlp.qkv_fold_supported(cfg, layer, next_layer, x)
        kw = dict(next_attn_norm=next_layer["attn_norm"], next_w_qkv=next_layer["w_qkv"]) if fold else {}
        res = qmlp.fused_layer_tail(
            x.reshape(-1, x.shape[-1]), layer["mlp_norm"], layer["w_gate_up"], layer["w_down"],
            eps=cfg.rms_norm_eps, attn_out=attn_out.reshape(-1, attn_out.shape[-1]),
            wo=layer["wo"], **kw,
        )
        y, qkv = res if fold else (res, None)
        return y.reshape(*lead, -1), None if qkv is None else qkv.reshape(*lead, -1)
    x = x + _reduce(quantized.matmul(attn_out, layer["wo"]), tp)
    return mlp_block(cfg, layer, x, tp, dp), None


def _reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """Sum a row-split product's partial sums over the tensor-parallel axis
    (Megatron's "g": the gradient passes through)."""
    return y if tp is None else tp.all_reduce(y)


def _column_input(h: torch.Tensor, tp) -> torch.Tensor:
    """The input of column-parallel products (Megatron's "f": ``h`` itself;
    its gradient, a partial sum on each rank, is summed over the axis)."""
    return h if tp is None else tp.copy(h)


def mlp_block(cfg: LlamaConfig, layer: Params, x: torch.Tensor, tp=None, dp=None) -> torch.Tensor:
    """norm -> SwiGLU or MoE FFN -> residual.  Under ``tp`` the normed input
    passes the "f" op and the row-split product's sums are all-reduced.
    An MoE FFN under ``tp`` also passes its replicated router through "f"
    (the combine weights it feeds multiply partial expert outputs, so each
    rank's router gradient is a partial sum), and under ``dp`` (training
    on a mesh) claims capacity over the whole batch (``moe.moe_ffn``)."""
    h = _column_input(rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps), tp)
    if cfg.num_experts > 0:
        from . import moe

        experts = layer["moe"]
        if tp is not None:
            experts = {**experts, "w_router": tp.copy(experts["w_router"])}
        # Capacity counts every row of x: padding rows of a prefill and the
        # idle slots of a decode step included, as in the JAX engine.
        return x + _reduce(moe.moe_ffn(experts, h, num_experts_per_tok=cfg.num_experts_per_tok,
                                       capacity_factor=cfg.capacity_factor, dp=dp), tp)
    if "w_gate_up" in layer:
        gate, up = quantized.matmul(h, layer["w_gate_up"]).chunk(2, dim=-1)
    else:
        gate = quantized.matmul(h, layer["w_gate"])
        up = quantized.matmul(h, layer["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return x + _reduce(quantized.matmul(act, layer["w_down"]), tp)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """Token embedding lookup; under ``tp`` vocab-parallel: each rank looks
    up the tokens inside its slice of the table, zeros elsewhere, and the
    rows are all-reduced."""
    table = params["embed"]
    if tp is None:
        return quantized.embed_lookup(table, tokens, cfg.dtype)
    rows = (table["q"] if quantized.is_quantized(table) else table).shape[0]
    local = tokens - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = quantized.embed_lookup(table, torch.where(inside, local, 0), cfg.dtype)
    return tp.all_reduce(torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)))


def _decoder(params, tokens, positions, cfg, attend_fn, collect_kv=False, last_pos=None, tp=None,
             dp=None):
    """embed -> [attention, MLP] x L -> norm -> head.  With ``last_pos``
    ((B,) int) the head runs only at that position of each row.  Under
    ``tp`` the layers run on this rank's heads and columns and the logits
    come back whole; ``attend_fn`` gets the local heads.  ``dp``: the
    data-parallel axis of a training mesh (MoE capacity, :func:`mlp_block`)."""
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = _embed(params, tokens, cfg, tp)
    lcfg = cfg if tp is None else local_config(cfg, tp.size)
    kv = []
    layers = params["layers"]
    qkv_pre = None
    for idx, layer in enumerate(layers):
        attn_out, k, v = _layer_attention(lcfg, idx, layer, x, cos, sin, attend_fn, qkv=qkv_pre, tp=tp)
        if collect_kv:
            kv.append((k, v))
        nxt = layers[idx + 1] if idx + 1 < len(layers) else None
        x, qkv_pre = _layer_tail(lcfg, layer, x, attn_out, next_layer=nxt, tp=tp, dp=dp)
    if last_pos is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, last_pos.to(x.device)][:, None, :]
    logits = decode_head(params, x, cfg, tp)
    return (logits, kv) if collect_kv else logits


def _fused_attend(cfg: LlamaConfig):
    return lambda _i, q, k, v: _attend(cfg, q, k, v, is_causal=True)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)


def mesh_axes(params: Params, cfg: LlamaConfig, mesh):
    """The (dp, tp) axes of a training mesh as ``parallel/mesh.Axis``, each
    None where the mesh has size 1 along it (or no mesh is given).  Checks
    that the config splits over tp and that ``params`` holds this rank's
    shards."""
    if mesh is None:
        return None, None
    from ..parallel import mesh as mesh_lib

    dp, tp = mesh_lib.axis(mesh, "dp"), mesh_lib.axis(mesh, "tp")
    n = tp.size
    for name in ("num_q_heads", "num_kv_heads", "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % n:
            raise ValueError(f"{name} ({getattr(cfg, name)}) must be divisible by the 'tp' "
                             f"axis size ({n})")
    wq = params["layers"][0].get("wq") if params["layers"] else None
    if isinstance(wq, torch.Tensor) and wq.shape[-1] != cfg.q_dim // n:
        raise ValueError(
            f"params hold {wq.shape[-1]} query columns a layer, this rank's shard has "
            f"{cfg.q_dim // n}: pass parallel/mesh.shard_params(params, mesh, "
            "llama_param_specs(cfg))")
    return (dp if dp.size > 1 else None), (tp if n > 1 else None)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *, positions=None, mesh=None):
    """(B, S) int tokens -> (B, S, vocab) fp32 logits (differentiable).

    ``mesh``: a mesh with axes ("dp", "tp") (``parallel/mesh.make_mesh``);
    ``params`` is then this rank's shards (``parallel/mesh.shard_params``
    under ``llama_param_specs(cfg)``), ``tokens`` its rows of the batch
    (``parallel/mesh.batch_spec``), and the logits those rows' whole
    vocabulary."""
    dp, tp = mesh_axes(params, cfg, mesh)
    if positions is None:
        positions = _positions(tokens)
    return _decoder(params, tokens, positions, cfg, _fused_attend(cfg), tp=tp, dp=dp)


@torch.no_grad()
def forward_prefill(
    params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
    positions=None, last_pos: Optional[torch.Tensor] = None,
):
    """Prefill forward that also returns per-layer post-RoPE K/V.

    Returns (logits, kv): kv is a list of (k, v), each (B, Hkv, S, D) in
    cfg.dtype.  With ``last_pos`` logits are (B, vocab)."""
    if positions is None:
        positions = _positions(tokens)
    logits, kv = _decoder(
        params, tokens, positions, cfg, _fused_attend(cfg),
        collect_kv=True, last_pos=last_pos,
    )
    if last_pos is not None:
        logits = logits[:, 0, :]
    return logits, kv


@torch.no_grad()
def forward_chunk(
    params: Params, tokens: torch.Tensor, positions: torch.Tensor,
    cfg: LlamaConfig, attend_fn: Callable, tp=None,
) -> torch.Tensor:
    """Chunked forward of a (B, T) token chunk at ``positions``: (T,), one
    chunk's positions for every row, or (B, T), each row's own (speculative
    verification: slot b's candidates start at its length; JAX
    llama.py:559-570).  ``attend_fn(layer_idx, q, k_new, v_new)`` takes
    (B, H, T, D) post-RoPE tensors and returns the chunk's attention output
    (the serving backends: attention over the cached prefix and the chunk,
    K1 with ``q_offset`` = the chunk's start; or K4's / K10's multi-query
    mode over the cache with the chunk appended).  Returns (B, T, vocab)
    fp32 logits.  ``tp``: the tensor-parallel axis (module docstring)."""
    return _decoder(params, tokens, positions, cfg, attend_fn, tp=tp)


def _lean_decode_supported(cfg: LlamaConfig, params: Params) -> bool:
    """May the decode step take the lean 2-D decode path?  Needs the fused
    ``w_qkv`` in every layer, no QKV biases and a dense FFN; the gate is
    structural only (llama.py:573-583 of the JAX package)."""
    if cfg.qkv_bias or cfg.num_experts > 0:
        return False
    return all("w_qkv" in layer for layer in params["layers"])


def decode_rope_tables(positions: torch.Tensor, cfg: LlamaConfig):
    """(B,) positions -> cos/sin of shape (B, 1, D/2), broadcast over the
    q and k heads of :func:`decode_qkv`."""
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return cos[:, None, :], sin[:, None, :]


def decode_qkv(cfg: LlamaConfig, qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """A (B, F) fused bias-free QKV projection -> rotated q (B, Hq, D), k
    (B, Hkv, D) and v (B, Hkv, D): RoPE runs once over the packed [q|k]
    block, with the same formula and order as ``apply_rope``."""
    batch = qkv.shape[0]
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    qk = qkv[:, : (hq + hkv) * d].reshape(batch, hq + hkv, 2, d // 2).float()
    x1, x2 = qk[:, :, 0], qk[:, :, 1]
    qk = torch.stack((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=2)
    qk = qk.reshape(batch, hq + hkv, d).to(cfg.dtype)
    v = qkv[:, (hq + hkv) * d :].reshape(batch, hkv, d)
    return qk[:, :hq], qk[:, hq:], v


def decode_head(params: Params, x: torch.Tensor, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """Final RMSNorm and LM head of (..., E) activations -> fp32 logits.
    Under ``tp`` the head is column-parallel (this rank's vocabulary
    slice, any padding columns cut off) and the logits are all-gathered."""
    x = _column_input(rms_norm(x, params["final_norm"], cfg.rms_norm_eps), tp)
    if cfg.tie_embeddings:
        logits = quantized.tied_head_matmul(x, params["embed"]).float()
    else:
        logits = quantized.matmul(x, params["lm_head"]).float()
    if tp is None:
        return logits
    return tp.all_gather(logits[..., : cfg.vocab_size // tp.size], dim=-1)


def _forward_decode_lean(params, tokens, positions, cfg: LlamaConfig, attend_fn):
    """Decode forward specialized to T == 1: activations stay (B, E), RoPE
    runs once over the packed [q|k] block (:func:`decode_qkv`), and each
    layer tail hands the next layer its QKV.  It needs a fused ``w_qkv``,
    which a tensor-parallel split refuses, so it takes no ``tp``."""
    batch = tokens.shape[0]
    cos, sin = decode_rope_tables(positions, cfg)
    x = quantized.embed_lookup(params["embed"], tokens, cfg.dtype)
    layers = params["layers"]
    qkv = None
    for idx, layer in enumerate(layers):
        if qkv is None:
            h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
            qkv = quantized.matmul(h, layer["w_qkv"])
        q, k, v = decode_qkv(cfg, qkv, cos, sin)
        attn = attend_fn(idx, q, k, v)
        attn = attn.to(x.dtype).reshape(batch, cfg.q_dim)
        nxt = layers[idx + 1] if idx + 1 < len(layers) else None
        x, qkv = _layer_tail(cfg, layer, x, attn, next_layer=nxt)
    return decode_head(params, x, cfg)


@torch.no_grad()
def forward_decode(
    params: Params, tokens: torch.Tensor, positions: torch.Tensor,
    cfg: LlamaConfig, attend_fn: Callable, tp=None,
):
    """One-token decode forward.

    tokens (B,) current tokens; positions (B,) their positions (== the
    pre-append cache lengths); ``attend_fn(layer_idx, q, k_new, v_new)``
    takes (B, H, D) post-RoPE tensors and returns (B, Hq, D).
    Returns (B, vocab) fp32 logits.  A fused-projection tree takes the
    lean decode path, as in JAX (llama.py:659-660).  ``tp``: the
    tensor-parallel axis (module docstring).
    """
    if tp is None and _lean_decode_supported(cfg, params):
        return _forward_decode_lean(params, tokens, positions, cfg, attend_fn)

    def attend_t1(idx, q, k, v):
        out = attend_fn(idx, q[:, :, 0, :], k[:, :, 0, :], v[:, :, 0, :])
        return out[:, :, None, :]

    logits = _decoder(params, tokens[:, None], positions[:, None], cfg, attend_t1, tp=tp)
    return logits[:, 0, :]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over (B, S) tokens, on fp32 logits.  Under
    a ``mesh`` (:func:`forward`) the mean over the whole batch: each dp
    rank's mean over its rows, averaged over dp (JAX llama.py:672-678 under
    GSPMD); its gradient on a rank is that rank's share."""
    logits = forward(params, tokens[:, :-1], cfg, mesh=mesh)
    targets = tokens[:, 1:].long()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    dp, _ = mesh_axes(params, cfg, mesh)
    return loss if dp is None else dp.all_reduce(loss) / dp.size


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order (top-level keys,
    then each layer's, an MoE subtree's in its own order)."""
    out = [v for k, v in tree.items() if k != "layers"]
    for layer in tree["layers"]:
        for k, v in layer.items():
            out.extend(v.values() if k == "moe" else (v,))
    return out


def tree_like(tree: Params, values: List[Any]) -> Params:
    """A tree of ``tree``'s structure holding ``values`` in ``leaves`` order."""
    it = iter(values)
    out = {k: next(it) for k in tree if k != "layers"}
    out["layers"] = [
        {k: {m: next(it) for m in v} if k == "moe" else next(it) for k, v in layer.items()}
        for layer in tree["layers"]
    ]
    return out


def loss_and_grads(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *, mesh=None):
    """(loss, grads): ``jax.value_and_grad(loss_fn)``; grads is a tree of
    params' structure (None for a leaf the loss does not reach).  A
    quantized tree raises: its int8/int4 leaves are not differentiable
    (quantized.py:17-19 of the JAX package).

    Under a ``mesh`` (:func:`forward`) the loss is the whole batch's and
    grads this rank's shards of the whole batch's gradient: each leaf's
    share is summed over dp (``parallel/mesh.all_reduce_``: leaf by leaf,
    in fp32, in pieces of at most 256 MB).  Partial sums over tp are
    summed inside the backward by the "f" ops (:func:`_column_input`), so
    a leaf replicated over the mesh gets the same bytes on every rank."""
    flat = leaves(params)
    if any(quantized.is_quantized(p) or quantized.is_quantized4(p) for p in flat):
        raise TypeError(
            "loss_and_grads: int8/int4 weight leaves are not differentiable; "
            "train the full-precision tree (models/quantized is inference only)"
        )
    flags = [p.requires_grad for p in flat]
    try:
        for p in flat:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p, flag in zip(flat, flags):
            p.requires_grad_(flag)
    dp, _ = mesh_axes(params, cfg, mesh)
    if dp is not None:
        from ..parallel import mesh as mesh_lib

        mesh_lib.all_reduce_(grads, mesh, "dp")
    return loss.detach(), tree_like(params, list(grads))


def train_step(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, lr: float = 1e-3, *,
               mesh=None):
    """One SGD step; returns (new_params, loss).  The update is computed in
    fp32 and cast back to each parameter's dtype, as in the JAX package
    (llama.py:681-693), but written into ``params`` in place, so the new
    parameters are ``params`` itself and an 8B model needs no second copy.
    Under a ``mesh`` (:func:`forward`) each rank updates its own shards
    with the whole batch's gradient (:func:`loss_and_grads`)."""
    loss, grads = loss_and_grads(params, tokens, cfg, mesh=mesh)
    with torch.no_grad():
        for p, g in zip(leaves(params), leaves(grads)):
            if g is not None:
                # p - lr * g in fp32 with one fp32 temporary a leaf: the
                # same roundings as p.float() - lr * g.float().
                p.copy_(g.to(torch.float32, copy=True).mul_(lr).neg_().add_(p))
    return params, loss
