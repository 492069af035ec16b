"""Operations and bytes of the work a cell asks for, from its shapes.

The yardstick of every roofline share and utilisation the benchmark
reports.  Counts are of what the inputs need, not of what a kernel happens
to do: padding rows, tiles past a window and recomputation are not work.

- Attention: the keys each query row sees, summed exactly over the rows
  (causal, with Mistral's window: HF's ``sliding_window = w`` lets a row see
  the last w keys, itself included; a chunk's rows start at ``q_offset``).
  Q.K^T and P.V are each 2 * D operations a key a query head.  This
  corrects the arithmetic frozen below (``dense_attention_flops``, the
  program's ``utils/profiling.attention_tflops``), which halves a causal
  square and knows no window, offset or ragged batch.
- Weight products: 2 operations a weight a row; int8 matrices read their
  codes (1 byte a weight) and one fp32 scale an output column.
- The int8 KV cache: each row of a layer holds K and V codes (1 byte an
  element) and one fp32 scale a KV head each.

Peaks are NVIDIA's data sheet for the H100 SXM, dense.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
HBM_BYTES_S = 3.35e12


def dense_attention_flops(batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
                          causal: bool = False) -> int:
    """The program's FLOP model, frozen: 4 * B * H * Sq * Skv * D, halved
    when causal (exact only for an unwindowed causal square at large S)."""
    flops = 2 * (2 * batch * heads * q_len * kv_len * head_dim)
    return flops // 2 if causal else flops


def attention_keys(q_len: int, kv_len: Optional[int] = None, q_offset: int = 0,
                   window: Optional[int] = None, causal: bool = True) -> int:
    """Keys summed over the query rows: row i sits at position q_offset + i
    and sees keys [0, kv_len), cut to those at or before it when causal and
    to its last ``window`` keys (itself included) under a window."""
    kv_len = q_offset + q_len if kv_len is None else kv_len
    pos = q_offset + np.arange(q_len, dtype=np.int64)
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(q_len, kv_len, np.int64)
    lo = np.zeros(q_len, np.int64) if window is None else np.maximum(pos + 1 - window, 0)
    return int(np.clip(hi - lo, 0, None).sum())


def attention_flops(keys: int, q_heads: int, head_dim: int) -> Dict[str, int]:
    """Q.K^T and P.V operations over ``keys`` (row, key) pairs a head."""
    one = 2 * head_dim * keys * q_heads
    return {"qk": one, "pv": one}


# ---------------------------------------------------------------------------
# Model shapes
# ---------------------------------------------------------------------------


def layer_matrices(cfg) -> Dict[str, tuple]:
    """(in, out) of one decoder layer's products, by leaf name; an MoE
    layer's expert stacks as (E, in, out) and its fp32 router."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    out = {
        "wq": (h, cfg.num_q_heads * cfg.head_dim),
        "wk": (h, cfg.num_kv_heads * cfg.head_dim),
        "wv": (h, cfg.num_kv_heads * cfg.head_dim),
        "wo": (cfg.num_q_heads * cfg.head_dim, h),
    }
    if cfg.num_experts:
        e = cfg.num_experts
        out.update({"moe.w_gate": (e, h, i), "moe.w_up": (e, h, i), "moe.w_down": (e, i, h)})
    else:
        out.update({"w_gate": (h, i), "w_up": (h, i), "w_down": (i, h)})
    return out


def int8_bytes(shape: Sequence[int]) -> int:
    """Codes plus one fp32 scale an output column (per expert for a stack)."""
    n = int(np.prod(shape))
    cols = int(np.prod(shape[:-2])) * shape[-1]
    return n + 4 * cols


def _weights(shape) -> int:
    return int(np.prod(shape))


def token_matmul_weights(cfg) -> int:
    """Weights a token meets in one layer's products: the attention
    projections, and the dense FFN or its top-k experts and the router."""
    mats = layer_matrices(cfg)
    n = sum(_weights(s) for k, s in mats.items() if not k.startswith("moe."))
    if cfg.num_experts:
        k = cfg.num_experts_per_tok
        n += k * sum(_weights(s[1:]) for name, s in mats.items() if name.startswith("moe."))
        n += cfg.hidden_size * cfg.num_experts
    return n


def layer_int8_bytes(cfg) -> int:
    """Bytes of one layer's int8 products (every expert of a stack)."""
    b = sum(int8_bytes(s) for s in layer_matrices(cfg).values())
    if cfg.num_experts:
        b += 4 * cfg.hidden_size * cfg.num_experts  # the fp32 router
    return b


def head_int8_bytes(cfg) -> int:
    return int8_bytes((cfg.hidden_size, cfg.vocab_size))


def cache_row_bytes(cfg) -> int:
    """One token's K and V in one layer of an int8 cache, scales included."""
    return 2 * cfg.num_kv_heads * (cfg.head_dim + 4)


def window_rows(cfg, length: int) -> int:
    return length if cfg.window is None else min(length, cfg.window)


# ---------------------------------------------------------------------------
# A decode step over slots
# ---------------------------------------------------------------------------


def decode_step(cfg, lengths: Iterable[int]) -> Dict[str, float]:
    """One decode step of the active slots, ``lengths`` their cache lengths
    after this step's append.  Bytes: every layer's int8 weights, the LM
    head and the cache rows each slot's query sees; an MoE layer's dense
    dispatch reads every expert, as any batch of many tokens does.
    Operations: each active token's products and attention."""
    lengths = list(lengths)
    rows = len(lengths)
    keys = sum(window_rows(cfg, n) for n in lengths)
    att = attention_flops(keys, cfg.num_q_heads, cfg.head_dim)
    flops = cfg.num_layers * (2 * rows * token_matmul_weights(cfg) + att["qk"] + att["pv"])
    flops += 2 * rows * cfg.hidden_size * cfg.vocab_size
    weight_bytes = cfg.num_layers * layer_int8_bytes(cfg) + head_int8_bytes(cfg)
    cache_bytes = cfg.num_layers * keys * cache_row_bytes(cfg)
    return {"flops": flops, "bytes": weight_bytes + cache_bytes, "cache_bytes": cache_bytes}


def k9_step(cfg, lengths: Iterable[int]) -> Dict[str, float]:
    """The fused decode layer K9 over every layer of one step: attention
    over the cache rows, wo, the MLP and the next layer's QKV (layer 0's
    QKV and the LM head run outside it)."""
    lengths = list(lengths)
    rows = len(lengths)
    m = layer_matrices(cfg)
    qkv = sum(int8_bytes(m[k]) for k in ("wq", "wk", "wv"))
    qkv_w = sum(_weights(m[k]) for k in ("wq", "wk", "wv"))
    tail = sum(int8_bytes(m[k]) for k in ("wo", "w_gate", "w_up", "w_down"))
    tail_w = sum(_weights(m[k]) for k in ("wo", "w_gate", "w_up", "w_down"))
    keys = sum(window_rows(cfg, n) for n in lengths)
    att = attention_flops(keys, cfg.num_q_heads, cfg.head_dim)
    layers = cfg.num_layers
    weight_bytes = layers * tail + (layers - 1) * qkv
    flops = layers * (2 * rows * tail_w + att["qk"] + att["pv"]) + (layers - 1) * 2 * rows * qkv_w
    return {"flops": flops, "bytes": weight_bytes + layers * keys * cache_row_bytes(cfg)}


def qmm_decode_step(cfg, rows: int) -> Dict[str, float]:
    """Every int8 weight product of one decode step outside K9 (the
    unfused route: attention projections, the dense FFN or every expert
    stack, the LM head) at ``rows`` active tokens."""
    mats = layer_matrices(cfg)
    w_bytes = cfg.num_layers * sum(int8_bytes(s) for s in mats.values()) + head_int8_bytes(cfg)
    flops = cfg.num_layers * 2 * rows * (token_matmul_weights(cfg) - cfg.num_experts * cfg.hidden_size)
    flops += 2 * rows * cfg.hidden_size * cfg.vocab_size
    return {"flops": flops, "bytes": w_bytes}


def bound_seconds(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time: operations at the peak or bytes at HBM's rate."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_call(cfg, prompt_lens: Sequence[int]) -> Dict[str, float]:
    """One whole-prompt prefill forward of a batch of prompts: the
    products at every real token, the LM head at each prompt's last token,
    causal windowed attention; the weights read once."""
    tokens = sum(prompt_lens)
    keys = sum(attention_keys(n, window=cfg.window) for n in prompt_lens)
    att = attention_flops(keys, cfg.num_q_heads, cfg.head_dim)
    products = cfg.num_layers * 2 * tokens * token_matmul_weights(cfg)
    products += 2 * len(prompt_lens) * cfg.hidden_size * cfg.vocab_size
    w_bytes = cfg.num_layers * layer_int8_bytes(cfg) + head_int8_bytes(cfg)
    return {
        "tokens": tokens,
        "products": products,
        "qk": cfg.num_layers * att["qk"],
        "pv": cfg.num_layers * att["pv"],
        "flops": products + cfg.num_layers * (att["qk"] + att["pv"]),
        "weight_bytes": w_bytes,
    }


def k1_seconds(qk: float, pv: float, fp8_qk: bool = True) -> float:
    """K1's least time: Q.K^T at the fp8 peak where the scores are fp8
    products, P.V at the bf16 peak."""
    return qk / (FP8_FLOPS if fp8_qk else BF16_FLOPS) + pv / BF16_FLOPS
