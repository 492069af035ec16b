"""Head-sharded tensor-parallel attention (counterpart of
quantumattention_tpu/parallel/tp.py).

Each rank runs K1 (``ops/flash.flash_attention``) on its own heads: heads
are independent in attention, so nothing is communicated (GQA
co-location keeps each KV head on the rank that owns its Q-head group).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.flash import flash_attention
from .mesh import axis_size, shard


def head_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "tp",
    scale_q: Optional[torch.Tensor] = None,
    scale_k: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention with heads sharded over ``mesh[axis_name]``.

    q (B, Hq, S, D), k/v (B, Hkv, S, D): the whole tensors, as every rank
    holds them (Hkv % axis size == 0, so each rank keeps whole GQA
    groups); head-wise (B, H) or token-wise (B, H, S) scales are sliced by
    head with them.  Returns this rank's heads of the output,
    (B, Hq / n, S, D)."""
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"q heads ({q.shape[1]}) and kv heads ({k.shape[1]}) must both "
            f"be divisible by the '{axis_name}' axis size ({n}); replicate "
            "KV instead for finer Q-head sharding"
        )

    def local(t):
        return None if t is None else shard(t, mesh, axis_name, 1)

    return flash_attention(
        local(q), local(k), local(v), scale_q=local(scale_q), scale_k=local(scale_k),
        is_causal=is_causal, sm_scale=sm_scale, window=window, block_q=block_q,
        block_kv=block_kv,
    )
