"""Ulysses (DeepSpeed-style) sequence parallelism by all-to-all
(counterpart of quantumattention_tpu/parallel/ulysses.py).

The alternative to ring attention (``parallel/ring.py``) over
sequence-sharded inputs: one all-to-all swaps the sharded dimension,
(B, H, S/n, D) -> (B, H/n, S, D), K1 runs on the whole sequence for the
rank's heads, and a second all-to-all swaps back.  Ulysses moves Q, K, V
and O once each whatever the length; it needs the head counts divisible by
the axis size and leaves the kernel's causal masking as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.flash import flash_attention
from .mesh import all_to_all, axis_size


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention over this rank's sequence shards q (B, Hq, S/n, D),
    k/v (B, Hkv, S/n, D); Hq and Hkv divisible by the axis size.  Returns
    this rank's (B, Hq, S/n, D) output shard."""
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(
            f"Ulysses needs q heads ({q.shape[1]}) and kv heads "
            f"({k.shape[1]}) divisible by the '{axis_name}' axis size ({n})"
        )

    def swap(t):  # (B, H, S/n, D) -> (B, H/n, S, D): scatter heads, gather sequence
        return all_to_all(t, mesh, axis_name, split_dim=1, concat_dim=2)

    out = flash_attention(
        swap(q), swap(k), swap(v), is_causal=is_causal, sm_scale=sm_scale, window=window,
        block_q=block_q, block_kv=block_kv,
    )
    return all_to_all(out, mesh, axis_name, split_dim=2, concat_dim=1)
