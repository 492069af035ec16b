"""Blockwise flash-attention backward (counterpart of
quantumattention_tpu/ops/flash_bwd.py).

:func:`flash_attention_bwd` runs kernels K2 (``flash_bwd_dq``, the port of
the Pallas ``_dq_kernel``, flash_bwd.py:112) and K3 (``flash_bwd_dkv``, the
port of ``_dkv_kernel``, flash_bwd.py:150), both in
``csrc/flash_bwd.cu``.  The math is flash_bwd.py:9-15, with P recomputed
from the forward's saved (m, l)::

    D  = rowsum(dO o O)                  (a torch reduction, as in JAX)
    P  = exp2(Q.K^T * sm_scale * log2 e - m) / l      (l == 0 -> P = 0)
    dP = dO.V^T,  dS = P o (dP - D)
    dQ = sm_scale dS.K,  dK = sm_scale dS^T.Q,  dV = P^T.dO

m and l are (B, Hq, Sq) fp32, as ``flash_attention(...,
return_residuals=True)`` returns them.  K3 sums the GQA group in the kernel
(a cluster of the group's CTAs, in a fixed order), so dK/dV come out
(B, Hkv, Skv, D) with no per-q-head buffers.

A CPU tensor runs each kernel's plain version (the same formulas on whole
(Sq, Skv) fp32 matrices); a CUDA tensor runs the kernel or raises.
``flash_bwd_dq.launches`` and ``flash_bwd_dkv.launches`` count launches.
Covered: bf16/fp16 (fp32 inputs enter the kernels rounded to bf16 and
their gradients return in fp32), GQA, ragged Sq/Skv, top-left causal, any
head dim JAX takes (a multiple of 8 up to 512, run at an instantiated width
of 64, 128, 256 or 512 with zero columns), and sliding windows as K1 takes
them (the right extent inactive under ``is_causal``, flash_bwd.py:225-226):
K2 walks only the KV tiles a Q block's rows can see, K3 only the Q rows
that can see a KV block, and P is 0 outside every row's window.  Neither
takes position offsets, as in JAX.  ``.window_launches`` counts each
kernel's launches with a window.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..utils import checks, shapes
from . import _native
from .flash import LOG2E, dense, extents, kernel_window, keep_mask, masked_scores, to_16bit

_FLOAT_DTYPES = (torch.bfloat16, torch.float16)


def _probs(q, k, m, l, is_causal, sm_scale, window=None) -> torch.Tensor:
    """P (B, Hq, Sq, Skv) fp32 from the saved (m, l); masked entries 0
    (also in a row that sees no key, whatever its m and l)."""
    s = masked_scores(q, k, is_causal, sm_scale, window=window)
    l_inv = torch.where(l == 0, 0.0, 1.0 / l)
    p = torch.exp2(s - m[..., None]) * l_inv[..., None]
    keep = keep_mask(q.shape[2], k.shape[2], is_causal, window, 0, 0, q.device)
    return p if keep is None else torch.where(keep, p, 0.0)


def _group_sum(t: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, S, D): sum over each KV head's q heads."""
    b, hq, s, d = t.shape
    return t.reshape(b, num_kv_heads, hq // num_kv_heads, s, d).sum(dim=2)


def _ds(q, k, v, do, m, l, delta, is_causal, sm_scale, window=None):
    """(P, dS) of the whole problem, fp32."""
    p = _probs(q, k, m, l, is_causal, sm_scale, window)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, m, l, delta, is_causal=False, sm_scale=None, window=None):
    """K2's plain version: dQ = sm_scale * dS.K, in q's dtype."""
    sm_scale = _default_scale(q, sm_scale)
    _, ds = _ds(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    kf = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return (torch.matmul(ds, kf) * sm_scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, m, l, delta, is_causal=False, sm_scale=None, window=None):
    """K3's plain version: dK = sm_scale * dS^T.Q and dV = P^T.dO, summed
    over each GQA group, in k's and v's dtypes."""
    sm_scale = _default_scale(q, sm_scale)
    p, ds = _ds(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), k.shape[1])
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), k.shape[1])
    return (dk * sm_scale).to(k.dtype), dv.to(v.dtype)


def _default_scale(q, sm_scale) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO o O), (B, Hq, Sq) fp32."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, do, m, l, is_causal=False, sm_scale=None, window=None):
    """The plain version of the whole backward: (dq, dk, dv)."""
    delta = row_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    *,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise backward; returns (dq, dk, dv) in the input dtypes.

    q, o, do (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), bf16, fp16 or fp32, one
    dtype; m, l the forward's (B, Hq, Sq) fp32 residuals; ``window`` the
    forward's (left, right), the right extent inactive under ``is_causal``.
    """
    window = kernel_window(window, is_causal)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    batch, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != d:
        raise ValueError(f"bad K/V shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if m.shape != (batch, hq, sq) or l.shape != (batch, hq, sq):
        raise ValueError(f"m and l must be (B, Hq, Sq) = {(batch, hq, sq)}")
    sm_scale = _default_scale(q, sm_scale)
    dtypes = (q.dtype, k.dtype, v.dtype)
    args = [q, k, v, do, m, l, row_delta(o, do)]
    stats = None
    if q.device.type != "cpu":
        args = [dense(to_16bit(t)) for t in args[:4]] + [t.float().contiguous() for t in args[4:]]
        stats = pack_stats(*args[4:])
    kw = dict(is_causal=is_causal, sm_scale=sm_scale, stats=stats, window=window)
    dq = flash_bwd_dq(*args, **kw)
    dk, dv = flash_bwd_dkv(*args, **kw)
    return dq.to(dtypes[0]), dk.to(dtypes[1]), dv.to(dtypes[2])


def _check_cuda(name, q, k, v, do, m, l, delta) -> None:
    checks.require_hopper(q.device)
    for t in (q, k, v, do, m, l, delta):
        if t.device != q.device:
            raise ValueError(f"all {name} operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError(f"{name}'s q, k, v, do must be 16-byte aligned")
    if len({t.dtype for t in (q, k, v, do)}) != 1 or q.dtype not in _FLOAT_DTYPES:
        raise ValueError(
            f"{name} takes q, k, v, do of one dtype, bf16 or fp16 (flash_attention_bwd "
            "rounds fp32 to bf16)"
        )
    if any(t.dtype != torch.float32 for t in (m, l, delta)):
        raise ValueError(f"{name} takes fp32 m, l, delta")
    shapes.check_kernel_head_dim(name, q.shape[-1])


def pack_stats(m: torch.Tensor, l: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The per-row statistics K2 and K3 read, (B, Hq, Sq_pad, 4) fp32 rows
    (m, 1/l, D, 0) with 1/l = 0 where l = 0 and zero rows past Sq (Sq_pad =
    Sq rounded up to 64), so that K3 takes a Q tile's rows in one bulk
    copy."""
    batch, hq, sq = m.shape
    out = torch.zeros((batch, hq, shapes.round_up(sq, 64), 4), dtype=torch.float32, device=m.device)
    out[:, :, :sq, 0] = m
    out[:, :, :sq, 1] = torch.where(l == 0, 0.0, 1.0 / l)
    out[:, :, :sq, 2] = delta
    return out


def _dims(q, k, stats):
    batch, hq, sq, d = q.shape
    return batch, hq, k.shape[1], sq, stats.shape[2], k.shape[2], d


def flash_bwd_dq(q, k, v, do, m, l, delta, *, is_causal=False, sm_scale=None, stats=None,
                 window=None):
    """Kernel K2 on CUDA tensors: dQ (B, Hq, Sq, D) in q's dtype.  ``stats``
    is ``pack_stats(m, l, delta)`` where the caller has it already."""
    window = kernel_window(window, is_causal)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    _check_cuda("K2", q, k, v, do, m, l, delta)
    sm_scale = _default_scale(q, sm_scale)
    dq = torch.empty_like(q)
    stats = pack_stats(m, l, delta) if stats is None else stats
    err = _native.library().qa_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        *_dims(q, k, stats), _native.dtype_code(q.dtype), int(bool(is_causal)),
        *extents(window), float(sm_scale * LOG2E), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.window_launches += window is not None
    return dq


def flash_bwd_dkv(q, k, v, do, m, l, delta, *, is_causal=False, sm_scale=None, stats=None,
                  window=None):
    """Kernel K3 on CUDA tensors: (dK, dV), each (B, Hkv, Skv, D).  ``stats``
    as K2's."""
    window = kernel_window(window, is_causal)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, m, l, delta, is_causal, sm_scale, window)
    _check_cuda("K3", q, k, v, do, m, l, delta)
    sm_scale = _default_scale(q, sm_scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stats = pack_stats(m, l, delta) if stats is None else stats
    err = _native.library().qa_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, stats), _native.dtype_code(q.dtype), int(bool(is_causal)),
        *extents(window), float(sm_scale * LOG2E), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.window_launches += window is not None
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.window_launches = 0
flash_bwd_dkv.window_launches = 0
