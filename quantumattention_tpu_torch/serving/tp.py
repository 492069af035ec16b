"""Tensor-parallel serving: parameter and cache sharding and head-sharded
attention for the continuous-batching engine (counterpart of
quantumattention_tpu/serving/tp.py).

Plain Megatron over a ``tp`` mesh axis, with local shards and explicit
collectives in place of GSPMD and ``shard_map``:

  * every rank holds its column/row slices of the weights
    (``parallel/mesh.param_specs_for``) and runs the model on them
    (``models/llama``'s ``tp`` argument: an all-reduce after wo and
    w_down, a vocab-parallel embedding, an all-gathered LM head);
  * the KV caches hold the rank's KV heads only (each rank owns whole GQA
    groups), so the cache writes and decode attention communicate nothing;
  * the attention kernels run on the local heads: K4 at decode
    (:func:`decode_attention_tp`), K1 with ``q_offset`` over the cached
    prefix at a prefill chunk (:func:`chunk_attention_tp`), K1 at a whole
    prefill (:func:`prefill_attend`).

The functions here take each rank's local tensors, as ``shard_map``'s body
sees them; head counts were checked where the whole shapes were known
(``Engine(mesh=...)``, :func:`shard_cache`, ``parallel/mesh.shard``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models import llama, quantized
from ..ops.decode import decode_attention
from ..parallel import mesh as mesh_lib
from . import kv_cache as kvc


def _is_local(params: llama.Params, cfg: llama.LlamaConfig, n: int) -> bool:
    """Whether ``params`` already holds one rank's slices (its first
    layer's Q projection has Hq / n heads' columns; any tree at n = 1)."""
    wq = params["layers"][0].get("wq")
    if wq is None:
        return False  # a fused tree: param_specs_for refuses it
    if isinstance(wq, dict):
        wq = wq["q4" if quantized.is_quantized4(wq) else "q"]
    return wq.shape[-1] == cfg.q_dim // n


def _pad_head(params: llama.Params) -> llama.Params:
    """A quantized LM head whose local vocabulary is not a multiple of 128
    columns (Llama-3's 128256 over 4 ranks: 32064), padded with zero
    columns to one: K5 takes N % 128 == 0.  ``llama.decode_head`` cuts the
    logits back to the rank's vocabulary before the all-gather."""
    head = params.get("lm_head")
    if not quantized.is_quantized(head) or head["q"].shape[-1] % 128 == 0:
        return params
    pad = -head["q"].shape[-1] % 128
    return {**params, "lm_head": {
        "q": torch.nn.functional.pad(head["q"], (0, pad)),
        "s": torch.nn.functional.pad(head["s"], (0, pad), value=1.0),
    }}


def shard_serving_params(
    params: llama.Params, cfg: llama.LlamaConfig, mesh, axis: str = "tp"
) -> llama.Params:
    """This rank's Megatron slices of a full-precision, int8 or int4 tree
    (a tree that already holds them is kept), a quantized LM head padded
    to a multiple of 128 columns (:func:`_pad_head`)."""
    n = mesh_lib.axis_size(mesh, axis)
    specs = mesh_lib.param_specs_for(params, cfg, axis)
    if not _is_local(params, cfg, n):
        params = mesh_lib.shard_params(params, mesh, specs)
    return _pad_head(params)


def shard_cache(cache: kvc.KVCache, mesh, axis: str = "tp") -> kvc.KVCache:
    """This rank's KV heads of a slot cache; lengths replicated."""
    local = lambda t: None if t is None else mesh_lib.shard(t, mesh, axis, 1)
    return dataclasses.replace(
        cache, k=local(cache.k), v=local(cache.v), lengths=cache.lengths.clone(),
        k_scale=local(cache.k_scale), v_scale=local(cache.v_scale),
    )


def decode_attention_tp(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    mesh,
    axis: str = "tp",
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> torch.Tensor:
    """K4 (``ops/decode.decode_attention``) on this rank's heads: q
    (B, Hq / n, D) and the rank's (B, Hkv / n, Smax, D) cache.  Heads are
    independent in attention, so nothing is communicated; the sum lives in
    the row-split output projection that follows."""
    if q.ndim != 3:
        raise ValueError(
            "decode_attention_tp takes (B, Hq, D) single-token queries "
            f"(got ndim={q.ndim}); multi-query verification is a "
            "single-chip path"
        )
    mesh_lib.axis(mesh, axis)
    return decode_attention(q, k_cache, v_cache, lengths, k_scale=k_scale, v_scale=v_scale,
                            window=window)


def chunk_attention_tp(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache: kvc.KVCache,
    slot: int,
    off: int,
    *,
    mesh,
    axis: str = "tp",
    window=None,
    kv_int4: bool = False,
    per_block: bool = False,
) -> torch.Tensor:
    """Chunked-prefill attention (the slot's cached prefix and the chunk)
    on this rank's heads: K1 with ``q_offset = off`` over the rank's KV-head
    shard of the prefix (``backends._chunk_prefix_attend``), no
    communication."""
    from .backends import _chunk_prefix_attend, slot_prefix

    mesh_lib.axis(mesh, axis)
    return _chunk_prefix_attend(q, k_new, v_new, slot_prefix(cache, slot, off, kv_int4), off,
                                window, per_block)


def prefill_attend(cfg: llama.LlamaConfig, mesh, axis: str = "tp"):
    """``attend_fn`` of ``models/llama._decoder``: the config's fused
    prefill attention (fp8, bf16 or SDPA) on the rank's heads."""
    mesh_lib.axis(mesh, axis)
    return lambda _i, q, k, v: llama._attend(cfg, q, k, v, is_causal=True)


@torch.no_grad()
def forward_prefill_tp(
    params: llama.Params,
    tokens: torch.Tensor,
    *,
    cfg: llama.LlamaConfig,
    mesh,
    axis: str = "tp",
    last_pos: Optional[torch.Tensor] = None,
):
    """``models/llama.forward_prefill`` over this rank's slices: returns the
    whole logits (all-gathered) and the rank's post-RoPE K/V heads per
    layer; ``last_pos`` restricts the LM head to one row per request."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    logits, kv = llama._decoder(
        params, tokens, positions, cfg, prefill_attend(cfg, mesh, axis), collect_kv=True,
        last_pos=last_pos, tp=mesh_lib.axis(mesh, axis),
    )
    if last_pos is not None:
        logits = logits[:, 0, :]
    return logits, kv
