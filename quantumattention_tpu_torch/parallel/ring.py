"""Ring sequence-parallel attention over a mesh axis (counterpart of
quantumattention_tpu/parallel/ring.py).

Each rank holds one sequence shard of Q, K and V.  K/V shards rotate
around the axis (a batched send/receive to rank + 1) while each rank runs
K1 on the shard in front of it with ``return_residuals=True``; the partial
(out, m, l) triples merge with the online-softmax rescale the kernel uses
between KV tiles, across ranks instead of tiles.  Causal masking holds
through the rotation because K1 takes global positions: rank r's Q rows
start at ``q_offset = r * S_local`` and the shard that arrived at step t
came from rank (r - t) mod n, at ``kv_offset = src * S_local``.

K1's residuals are (B, Hq, Sq) fp32 in the exp2 domain (``ops/flash.py``),
so the merge is in base 2.  JAX's ``config.kernel.use_exp2`` (a natural-exp
kernel) has no counterpart in the port, nor has its merge in base e.

A row that sees no key of a shard (under a window, or a causal shard
partly past the diagonal) merges with weight zero: its (m, l) carry no
meaning (``ops/flash.residuals_plain``), so the merge decides by position
which rows saw a key, never from m and l.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.flash import flash_attention, kernel_window, out_dtype_for
from .mesh import axis_rank, axis_size, shift


def _merge_unnormalized(u, m, l, o_t, m_t, l_t, sees):
    """Fold one shard's normalized partial (o_t, m_t, l_t) into the running
    unnormalized accumulator (u, m, l) (ring.py:37-61):

      m' = max(m, m_t)
      u' = u 2^(m - m') + o_t l_t 2^(m_t - m')
      l' = l 2^(m - m') + l_t 2^(m_t - m')

    Rows where ``sees`` is False contribute nothing; a row with nothing
    seen yet has m = -inf and weight zero."""
    m_t = torch.where(sees, m_t, float("-inf"))
    m_new = torch.maximum(m, m_t)
    safe = torch.where(torch.isinf(m_new), 0.0, m_new)
    a = torch.where(torch.isinf(m), 0.0, torch.exp2(m - safe))
    b = torch.where(sees, torch.exp2(m_t - safe), 0.0) * l_t
    u = u * a[..., None] + o_t.float() * b[..., None]
    return u, m_new, l * a + b


def _rows_seeing(q_len: int, q_off: int, kv_len: int, kv_off: int, is_causal: bool, window,
                 device) -> torch.Tensor:
    """(Sq,) bool: which query rows see at least one of the shard's keys."""
    p = torch.arange(q_len, device=device) + q_off
    lo = torch.full_like(p, kv_off)
    hi = torch.full_like(p, kv_off + kv_len - 1)
    if is_causal:
        hi = torch.minimum(hi, p)
    win = kernel_window(window, is_causal)
    if win is not None:
        left, right = win
        if left is not None:
            lo = torch.maximum(lo, p - left)
        if right is not None:
            hi = torch.minimum(hi, p + right)
    return lo <= hi


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    scale_q: Optional[torch.Tensor] = None,
    scale_k: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel fused attention over ``mesh[axis_name]``.

    q (B, Hq, S/n, D), k/v (B, Hkv, S/n, D): this rank's sequence shards
    (rank r holds positions [r S/n, (r + 1) S/n)).  ``scale_q``/``scale_k``:
    dequantization scales of 8-bit q/k, head-wise (B, H), which every rank
    holds whole, or token-wise (B, H, S/n), this rank's shard; token-wise
    ``scale_k`` rotates with its K.  Returns this rank's (B, Hq, S/n, D)
    output shard, bf16 for an 8-bit V.

    Under causal masking a shard wholly above this rank's diagonal launches
    no kernel (JAX's ``lax.cond``, ring.py:115-124).  The K/V shards make
    n - 1 hops; JAX's last hop, which only brings them home, is not made."""
    has_scales = scale_q is not None
    if has_scales and scale_q.ndim not in (2, 3):
        raise ValueError(
            "ring_attention scales must be head-wise (B, H) or token-wise "
            f"(B, H, S); got rank {scale_q.ndim}"
        )
    if has_scales and (scale_k is None or scale_q.ndim != scale_k.ndim):
        raise ValueError("scale_q/scale_k rank mismatch")
    tokenwise = has_scales and scale_q.ndim == 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n, rank = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    batch, heads, q_len, head_dim = q.shape
    kv_len = k.shape[2]
    q_off = rank * q_len

    u = torch.zeros((batch, heads, q_len, head_dim), dtype=torch.float32, device=q.device)
    m = torch.full((batch, heads, q_len), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, heads, q_len), dtype=torch.float32, device=q.device)
    blk = [k, v] + ([scale_k] if tokenwise else [])
    for t in range(n):
        src = (rank - t) % n
        kv_off = src * kv_len
        if not (is_causal and kv_off > q_off + q_len - 1):
            o_t, (m_t, l_t) = flash_attention(
                q, blk[0], blk[1], scale_q=scale_q,
                scale_k=blk[2] if tokenwise else scale_k, is_causal=is_causal,
                sm_scale=sm_scale, window=window, q_offset=q_off, kv_offset=kv_off,
                block_q=block_q, block_kv=block_kv, return_residuals=True,
            )
            sees = _rows_seeing(q_len, q_off, kv_len, kv_off, is_causal, window, q.device)
            u, m, l = _merge_unnormalized(u, m, l, o_t, m_t, l_t, sees)
        if t + 1 < n:
            blk = shift(blk, mesh, axis_name)
    o = u * torch.where(l == 0.0, 0.0, 1.0 / l)[..., None]
    return o.to(out_dtype_for(v.dtype))
