"""Fused flash-attention forward (counterpart of quantumattention_tpu/ops/flash.py).

``flash_attention`` is the wrapper of kernel K1 (``csrc/flash_fwd.cu``,
the port of the Pallas ``_flash_kernel``, flash.py:123).  A CPU tensor runs
the kernel's plain version, :func:`flash_attention_plain`; a CUDA tensor
runs the kernel or raises.  ``flash_attention.launches`` counts launches.

Covered: no scaling (bf16/fp16/fp32), head-wise (B, H) and token-wise
(B, H, S) scales on e4m3 or int8 Q/K, GQA, ragged Sq/Skv, top-left causal
masking, any head dim JAX takes (a multiple of 8 up to 512; the kernel
runs it at an instantiated width of 64, 128, 256 or 512 with zero columns),
``return_residuals`` (the backward's (m, l),
as (B, Hq, Sq) fp32 rather than the TPU's 128-lane replication), sliding
windows ``window = (left, right)`` (query position p sees the keys at
[p - left, p + right], ``None`` an unbounded side; under ``is_causal`` the
right extent is inactive, flash.py:398-409), and the position offsets
``q_offset`` and ``kv_offset``, the global positions of q's and k's row 0
(chunked prefill: every mask compares global positions, and the kernel's
tile skipping follows them, flash.py:712-736, :862-875).  A query row that
sees no key comes out as zeros, as JAX's kernel gives it (flash.py:573-578;
the fp32 oracle would give the mean of V there).
The kernel's products take 8- and 16-bit operands: on the card fp32 Q/K/V
enter rounded to bf16, and the kernel stores the fp32 output unrounded.
8-bit Q/K whose rows are not a multiple of 16 bytes (D % 16 == 8) go to the
kernel zero-padded to D + 8 columns (:func:`pad_8bit_columns`: a TMA tensor
map's row stride is a multiple of 16 bytes), and the output is cut back.

Per-block scaling (``fused_block_quant=True``, JAX's in-kernel dynamic
quantization, flash.py:227-369): float Q and K get one e4m3 scale per
(batch, head, block of ``block_q`` / ``block_kv`` rows counted from row 0),
``quant.quantize_block_wise``'s formula, and the scores are (q8 . k8^T) *
s_q * s_k * sm_scale * log2 e.  On the card the quantizer kernel
(``quant.block_quant``, ``csrc/block_quant.cu``) runs on Q and on K, then K1
in its token-wise mode over the expanded row scales
(``flash_attention.block_quant_launches`` counts the quantizer's launches).
The block sizes come from the arguments, then ``config.kernel.block_q`` /
``block_kv``, then JAX's heuristic (:func:`heuristic_blocks`).  Unlike JAX,
they set the quantization granularity only, never K1's tiles, and the
autotuner never changes them: a per-block result depends on the shape and
the config, not on a tuning cache.

K1's tiles: at widths 64 and 128 two tile configurations exist
(``autotune.K1_TILES``; the default 192 Q rows a CTA, and 128 rows over KV
tiles of 128).  A call takes the one the autotuner's cache names for its
shape class (JAX's ``flash``, ``flash-q2``, ``flash-q3`` and
``flash-block`` kinds), else the default.  A miss runs a timed sweep only in
per-block calls and inside ``autotune.tuning()`` (the ``"auto"`` path's
sweep), with ``config.kernel.autotune`` on and no graph being captured, so
every other path keeps the default configuration until a sweep has named
another.  The configurations sum the online softmax over different KV tiles
and so differ in the last bits; each is bitwise repeatable.

Three masks and operand modes of JAX's kernel ride on K1 as runtime
operands, each combining with everything above:

- segment ids ``q_segment_ids`` (B, Sq) / ``kv_segment_ids`` (B, Skv)
  (flash.py:413-419, :997-1016): a query sees the keys of its own segment
  (packed documents);
- ``block_mask``, a (ceil(Sq/128), ceil(Skv/128)) bitmap of 128 x 128
  granules (``MASK_GRANULE``; entries > 0 active, flash.py:880-952): a
  query sees the keys of its row's active granules.  :func:`block_table`
  turns it, on the device and without a host synchronisation, into K1's
  list of the KV tiles each Q block must visit, so off tiles are never
  loaded (JAX's compacted grid at K1's tiles);
- an int8 V with per-channel scales ``scale_v`` (B, Hkv, D)
  (``quant.quantize_channel_wise``; flash.py:501-515): V's codes enter
  P.V widened to bf16, and the output's columns are multiplied by their
  scales.  P stays bf16, where JAX rounds it to round(127 p) int8 for the
  TPU's 8-bit matrix unit.

A call with any of them takes K1's default tile configuration and never
consults the autotuner (JAX skips its tuner under a block mask,
flash.py:806-814).  Rows that see no key give zeros.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .. import autotune, config
from ..utils import checks, shapes
from . import _native, quant
from .sdpa import DEFAULT_MASK_VALUE, position_keep, sdpa_reference, segment_keep

LOG2E = math.log2(math.e)
#: The kernel's extent of an unbounded window side (csrc/flash_fwd.cu).
NO_EXTENT = 1 << 30
#: Granule of the block-sparse bitmap, in rows and keys (JAX flash.py:63;
#: ``kGranule`` in csrc/flash_fwd.cuh).
MASK_GRANULE = 128


def _scaling(scale_q, scale_k) -> str:
    if (scale_q is None) != (scale_k is None):
        raise ValueError("scale_q and scale_k must be given together")
    if scale_q is None:
        return "none"
    if scale_q.ndim == 2:
        return "head"
    if scale_q.ndim == 3:
        return "token"
    raise ValueError(f"bad scale rank: {scale_q.ndim}")


def heuristic_blocks(q_len: int, kv_len: int, head_dim: int) -> tuple:
    """JAX's default (block_q, block_kv) (flash.py:71-89): (1024, 2048)
    below D = 256, (512, 1024) from 256, each capped at the length rounded
    up to 128.  Here the per-block quantization's granularity."""
    bq, bkv = (512, 1024) if head_dim >= 256 else (1024, 2048)
    return min(bq, shapes.round_up(q_len, 128)), min(bkv, shapes.round_up(kv_len, 128))


def block_sizes(q_len: int, kv_len: int, head_dim: int, block_q=None, block_kv=None) -> tuple:
    """Per-block quantization blocks: the arguments, then
    ``config.kernel.block_q`` / ``block_kv``, then :func:`heuristic_blocks`."""
    bq = block_q or config.kernel.block_q
    bkv = block_kv or config.kernel.block_kv
    h_bq, h_bkv = heuristic_blocks(q_len, kv_len, head_dim)
    bq, bkv = int(bq or h_bq), int(bkv or h_bkv)
    if bq < 1 or bkv < 1:
        raise ValueError(f"block sizes must be >= 1, got ({bq}, {bkv})")
    return bq, bkv


def _block_operands(q, k, block_q, block_kv):
    """Per-block e4m3 codes of q and k with their (B, H, S) row scales: the
    plain version's inputs in per-block mode."""
    bq, bkv = block_sizes(q.shape[2], k.shape[2], q.shape[-1], block_q, block_kv)
    q8, sq = quant.quantize_block_wise(q, bq)
    k8, sk = quant.quantize_block_wise(k, bkv)
    return (q8, k8, quant.expand_block_scales(sq, bq, q.shape[2]),
            quant.expand_block_scales(sk, bkv, k.shape[2]))


def out_dtype_for(v_dtype) -> torch.dtype:
    """v's float dtype; an 8-bit v gives bf16 (flash.py:1100-1102)."""
    return torch.bfloat16 if checks.is_8bit_dtype(v_dtype) else v_dtype


def kernel_window(window, is_causal: bool):
    """``window`` as the masks read it: ``None``, or ``(left, right)`` with
    the right extent dropped under ``is_causal`` (JAX flash.py:398-409,
    flash_bwd.py:225-226).  Raises on what is not a pair of ints or None."""
    if window is None:
        return None
    if len(window) != 2:
        raise ValueError(f"window must be (left, right), got {window!r}")
    left, right = (None if e is None else int(e) for e in window)
    if is_causal:
        right = None
    return None if left is None and right is None else (left, right)


def extents(window) -> tuple:
    """(left, right) ints for the kernels, NO_EXTENT for an unbounded side."""
    if window is None:
        return NO_EXTENT, NO_EXTENT
    return tuple(NO_EXTENT if e is None else e for e in window)


def segment_ids(q_segment_ids, kv_segment_ids, batch: int, sq: int, skv: int, device):
    """The segment ids as (B, Sq) / (B, Skv) int32 on ``device``, or
    (None, None), with JAX's validation (flash.py:997-1006)."""
    if q_segment_ids is None and kv_segment_ids is None:
        return None, None
    if q_segment_ids is None or kv_segment_ids is None:
        raise ValueError("both q/kv segment ids must be provided")
    q_ids, kv_ids = torch.as_tensor(q_segment_ids), torch.as_tensor(kv_segment_ids)
    if tuple(q_ids.shape) != (batch, sq) or tuple(kv_ids.shape) != (batch, skv):
        raise ValueError(
            "segment ids must be (B, Sq) / (B, Skv), got "
            f"{tuple(q_ids.shape)} / {tuple(kv_ids.shape)}"
        )
    return (q_ids.to(device=device, dtype=torch.int32).contiguous(),
            kv_ids.to(device=device, dtype=torch.int32).contiguous())


def granules(block_mask, sq: int, skv: int, device) -> torch.Tensor:
    """``block_mask`` as a (ceil(Sq/128), ceil(Skv/128)) bool bitmap on
    ``device``, an entry active where its int32 value is > 0 (JAX casts
    the mask to int32, flash.py:887-895); raises on another shape."""
    g = MASK_GRANULE
    expected = (-(-sq // g), -(-skv // g))
    bm = torch.as_tensor(block_mask)
    if tuple(bm.shape) != expected:
        raise ValueError(
            f"block_mask must be (ceil(Sq/{g}), ceil(Skv/{g})) = {expected}, got {tuple(bm.shape)}"
        )
    return bm.to(device=device).to(torch.int32) > 0


def granule_keep(bitmap: torch.Tensor, sq: int, skv: int) -> torch.Tensor:
    """(Sq, Skv) bool of a granule bitmap expanded to elements."""
    g = MASK_GRANULE
    return bitmap.repeat_interleave(g, dim=0)[:sq].repeat_interleave(g, dim=1)[:, :skv]


def block_table(bitmap: torch.Tensor, sq: int, skv: int, block_rows: int, tile_cols: int,
                is_causal: bool, window=None):
    """K1's tile list under a block mask: for each Q block of
    ``block_rows`` rows, the KV tiles of ``tile_cols`` keys that hold an
    active granule for some 64-row consumer group of the block and lie in
    the block's causal / window / ragged range (the kernel's own, so
    offsets are 0: a block mask takes none).  JAX's compacted grid
    (flash.py:913-940) at K1's tile sizes.  Returns (counts (nQB,) int32,
    tiles (nQB, ceil(Skv / tile_cols)) int32): the first counts[i] entries
    of row i are its tiles in ascending order, the rest the others.  Torch
    ops only, none of which waits for the device, so a graph can capture
    it with the bitmap on the card."""
    g = MASK_GRANULE
    if block_rows % 64 or g % 64 or g % tile_cols:
        raise ValueError(f"K1's tiles ({block_rows}, {tile_cols}) do not nest in the granule")
    groups = -(-sq // 64)
    n_blocks = -(-sq // block_rows)
    n_tiles = -(-skv // tile_cols)
    per_group = bitmap.repeat_interleave(g // 64, dim=0)[:groups]
    per_tile = per_group.repeat_interleave(g // tile_cols, dim=1)[:, :n_tiles].to(torch.uint8)
    pad = torch.zeros((n_blocks * (block_rows // 64) - groups, n_tiles), dtype=torch.uint8,
                      device=bitmap.device)
    act = torch.cat([per_tile, pad]).reshape(n_blocks, block_rows // 64, n_tiles).amax(dim=1) > 0
    left, right = extents(kernel_window(window, is_causal))
    up = 0 if is_causal else right
    q0 = torch.arange(n_blocks, device=bitmap.device, dtype=torch.int64) * block_rows
    first = torch.clamp(q0 - left, min=0) // tile_cols
    end = torch.clamp(q0 + block_rows + up, min=0, max=skv)
    j = torch.arange(n_tiles, device=bitmap.device, dtype=torch.int64)[None, :]
    act &= (j >= first[:, None]) & (j * tile_cols < end[:, None])
    counts = act.sum(dim=1, dtype=torch.int32)
    tiles = torch.argsort((~act).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    return counts, tiles


def keep_mask(sq, skv, is_causal, window, q_offset, kv_offset, device, q_segment_ids=None,
              kv_segment_ids=None, block_mask=None):
    """(Sq, Skv) bool of the keys each query row sees by position, with a
    block mask's granules, and (B, 1, Sq, Skv) with segment ids; None for
    all."""
    keep = position_keep(sq, skv, is_causal, kernel_window(window, is_causal),
                         q_offset, kv_offset, device)
    if block_mask is not None:
        elem = granule_keep(granules(block_mask, sq, skv, device), sq, skv)
        keep = elem if keep is None else keep & elem
    seg = segment_keep(*(None if t is None else torch.as_tensor(t).to(device)
                         for t in (q_segment_ids, kv_segment_ids)))
    if seg is not None:
        keep = seg if keep is None else keep & seg
    return keep


def flash_attention_plain(
    q, k, v, scale_q=None, scale_k=None, is_causal=False, sm_scale=None,
    return_residuals=False, q_offset: int = 0, window=None, kv_offset: int = 0,
    fused_block_quant=False, block_q=None, block_kv=None, *, scale_v=None,
    q_segment_ids=None, kv_segment_ids=None, block_mask=None,
):
    """K1's plain version: dequantize, then the fp32 oracle, with zeros in
    the rows that see no key.  With ``return_residuals`` also (m, l) from
    the fp32 logits.  ``fused_block_quant``: q and k quantized per block
    first (:func:`quant.quantize_block_wise`).  An int8 ``v`` enters as
    ``v * scale_v[:, :, None, :]``; segment ids and the block mask's
    granules (expanded to elements) join the mask."""
    out_dtype = out_dtype_for(v.dtype)
    if fused_block_quant:
        q, k, scale_q, scale_k = _block_operands(q, k, block_q, block_kv)
    if scale_v is not None and v.dtype == torch.int8:
        v = quant.dequantize(v, scale_v, axis=-2)
    keep = keep_mask(q.shape[2], k.shape[2], is_causal, window, q_offset, kv_offset, q.device,
                     q_segment_ids, kv_segment_ids, block_mask)
    out = sdpa_reference(
        q, k, v, attn_mask=keep, scale=sm_scale, scale_q=scale_q, scale_k=scale_k,
        out_dtype=out_dtype,
    )
    if keep is not None:
        out = torch.where(keep.any(dim=-1)[..., None], out, torch.zeros((), dtype=out.dtype))
    if not return_residuals:
        return out
    return out, residuals_plain(q, k, scale_q, scale_k, is_causal, sm_scale, q_offset, window,
                                kv_offset, keep=keep)


def masked_scores(q, k, is_causal, sm_scale, scale_q=None, scale_k=None, q_offset: int = 0,
                  window=None, kv_offset: int = 0, fused_block_quant=False, block_q=None,
                  block_kv=None, keep=None):
    """(B, Hq, Sq, Skv) fp32 scores in K1's exp2 domain (times
    sm_scale * log2 e), masked entries at MASK_VALUE; ``keep`` (of
    :func:`keep_mask`) replaces the position mask where given."""
    if fused_block_quant:
        q, k, scale_q, scale_k = _block_operands(q, k, block_q, block_kv)
    qf = q.float() if scale_q is None else quant.dequantize(q, scale_q)
    kf = k.float() if scale_k is None else quant.dequantize(k, scale_k)
    kf = kf.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (sm_scale * LOG2E)
    if keep is None:
        keep = keep_mask(q.shape[2], k.shape[2], is_causal, window, q_offset, kv_offset, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    return s


def residuals_plain(
    q, k, scale_q=None, scale_k=None, is_causal=False, sm_scale=None, q_offset: int = 0,
    window=None, kv_offset: int = 0, keep=None,
):
    """Row max m and row sum l = sum(exp2(s - m)) of the exp2-domain
    scores, each (B, Hq, Sq) fp32, as K1 saves them (a row that sees no
    key has no meaningful pair; the kernel's may differ there)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = masked_scores(q, k, is_causal, sm_scale, scale_q, scale_k, q_offset, window, kv_offset,
                      keep=keep)
    m = s.amax(dim=-1)
    return m, torch.exp2(s - m[..., None]).sum(dim=-1)


def _offset(name: str, value) -> int:
    value = 0 if value is None else int(value)
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")
    return value


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale_q: Optional[torch.Tensor] = None,
    scale_k: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    return_residuals: bool = False,
    window=None,
    q_offset=None,
    kv_offset=None,
    fused_block_quant: bool = False,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    scale_v: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    block_mask: Optional[torch.Tensor] = None,
):
    """Fused attention forward over (B, H, S, D) tensors.

    q (B, Hq, Sq, D) bf16/fp16/fp32, or e4m3/int8 with scales; k
    (B, Hkv, Skv, D) of q's dtype, Hq % Hkv == 0; v (B, Hkv, Skv, D)
    bf16/fp16/fp32/e4m3, or int8 with ``scale_v`` (B, Hkv, D) fp32
    per-channel scales (``quant.quantize_channel_wise``; a ``scale_v``
    beside a float v is checked and unused, as in JAX).
    ``scale_q``/``scale_k``: (B, H) head-wise or (B, H, S) token-wise fp32
    dequantization scales, both or neither.  ``sm_scale`` defaults to
    1/sqrt(D).  Returns (B, Hq, Sq, D) in v's float dtype; with
    ``return_residuals`` ``(out, (m, l))``, the row max and row sum of the
    online softmax in the exp2 domain of the scores times
    ``sm_scale * log2 e`` (and the scales), each (B, Hq, Sq) fp32.
    ``window = (left, right)``: query position p sees the keys at
    positions [p - left, p + right] (``None`` an unbounded side; the right
    extent is inactive under ``is_causal``).  ``q_offset`` and
    ``kv_offset`` (ints or 0-d int tensors, read once on the host) are the
    global positions of q's and k's row 0: with ``is_causal`` row i sees
    the keys at positions <= q_offset + i, so Sq may be shorter than Skv
    (chunked prefill), and K may start past position 0 (a prefix cut to
    the window).  A query row that sees no key gives zeros.
    ``fused_block_quant``: float q and k are quantized to e4m3 per block of
    ``block_q`` / ``block_kv`` rows (:func:`block_sizes`; blocks count
    from row 0 whatever the offsets), no scales passed.  ``block_q`` and
    ``block_kv`` set that granularity only: K1's tiles are its own
    (module docstring).
    ``q_segment_ids`` (B, Sq) and ``kv_segment_ids`` (B, Skv), integer,
    both or neither: a query sees only the keys of its segment.
    ``block_mask``: a (ceil(Sq/128), ceil(Skv/128)) bool or integer bitmap
    (CPU or CUDA; keep it on the card to capture the call in a graph) of
    128 x 128 granules, a query seeing the keys of its row's active
    granules; no position offsets with it.  Calls with these or an int8 v
    run K1's default tile configuration, untuned.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    scaling = _scaling(scale_q, scale_k)
    if fused_block_quant:
        if scaling != "none":
            raise ValueError("fused_block_quant quantizes in-kernel; do not pass scales")
        if checks.is_8bit_dtype(q.dtype) or checks.is_8bit_dtype(k.dtype):
            raise ValueError("fused_block_quant expects float q/k")
        block_q, block_kv = block_sizes(q.shape[2], k.shape[2], q.shape[-1], block_q, block_kv)
    if q.dtype == torch.int8 and scaling == "none":
        raise ValueError("int8 q/k require scales")
    (batch, _, sq, _), (_, hkv, skv, dv) = q.shape, v.shape
    if v.dtype == torch.int8 and scale_v is None:
        raise ValueError("int8 v requires per-channel scale_v (B, Hkv, D)")
    if scale_v is not None and tuple(scale_v.shape) != (batch, hkv, dv):
        raise ValueError(f"scale_v must be (B, Hkv, D), got {tuple(scale_v.shape)}")
    if v.dtype != torch.int8:
        scale_v = None
    bitmap = None
    if block_mask is not None:
        if q_offset is not None or kv_offset is not None:
            raise ValueError("block_mask with ring position offsets is not supported")
        bitmap = granules(block_mask, sq, skv, q.device)
    q_ids, kv_ids = segment_ids(q_segment_ids, kv_segment_ids, batch, sq, skv, q.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q_offset = _offset("q_offset", q_offset)
    kv_offset = _offset("kv_offset", kv_offset)
    window = kernel_window(window, is_causal)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, scale_q, scale_k, is_causal, sm_scale, return_residuals, q_offset, window,
            kv_offset, fused_block_quant, block_q, block_kv, scale_v=scale_v,
            q_segment_ids=q_ids, kv_segment_ids=kv_ids, block_mask=bitmap,
        )
    out_dtype = out_dtype_for(v.dtype)
    d = q.shape[-1]
    shapes.check_kernel_head_dim("K1", d)
    modes = scale_v is not None or q_ids is not None or bitmap is not None
    tile_key = None if modes else _tile_key(q, k, scale_q, fused_block_quant, is_causal, window)
    if fused_block_quant:
        q, _, scale_q = quant.block_quant(q, block_q)
        k, _, scale_k = quant.block_quant(k, block_kv)
        flash_attention.block_quant_launches += 2
        scaling = "token"
        v = _pad_columns(to_16bit(v), q.shape[-1])
    else:
        q, k, v = pad_8bit_columns(*(to_16bit(t) for t in (q, k, v)))
    if scale_v is not None:
        scale_v = _pad_columns(scale_v.float(), q.shape[-1]).contiguous()
    run = functools.partial(
        _flash_fwd_cuda, dense(q), dense(k), dense(v),
        None if scale_q is None else scale_q.float().contiguous(),
        None if scale_k is None else scale_k.float().contiguous(),
        scaling, is_causal, sm_scale, return_residuals, q_offset, out_dtype, window, kv_offset,
        scale_v=scale_v, q_segment_ids=q_ids, kv_segment_ids=kv_ids, bitmap=bitmap,
    )
    res = run(tiles=_k1_tiles(tile_key, q, k, fused_block_quant, run))
    if q.shape[-1] == d:
        return res
    out = (res[0] if return_residuals else res)[..., :d].contiguous()
    return (out, res[1]) if return_residuals else out


def pad_8bit_columns(q, k, v):
    """(q, k, v) with zero columns up to the next multiple of 16 when q and
    k are 8-bit and D % 16 == 8, else as given.  A tensor map's row stride
    is a multiple of 16 bytes; the zero columns change neither Q.K^T nor
    the output's first D columns (sm_scale must come from the true D)."""
    d = q.shape[-1]
    if not checks.is_8bit_dtype(q.dtype) or d % 16 == 0:
        return q, k, v
    return tuple(_pad_columns(t, shapes.round_up(d, 16)) for t in (q, k, v))


def _pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns up to ``width`` (itself when it has them)."""
    if t.shape[-1] == width:
        return t
    p = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype, device=t.device)
    p[..., :t.shape[-1]] = t
    return p


def _tile_key(q, k, scale_q, fused_block_quant: bool, is_causal: bool, window):
    """The autotuner's key of K1's tile configuration for this call (JAX's
    kinds, flash.py:606-621), or None where only one configuration exists
    or autotune is off."""
    d = q.shape[-1]
    if not config.kernel.autotune or len(autotune.K1_TILES[shapes.kernel_width(d)]) == 1:
        return None
    if fused_block_quant:
        kind = "flash-block"
    elif scale_q is not None:
        kind = f"flash-q{scale_q.ndim}"
    else:
        kind = "flash"
    if window is not None:
        kind += f"-w{window[0]}_{window[1]}"
    (b, hq, sq, _), (_, hkv, skv, _) = q.shape, k.shape
    return autotune.shape_key(kind, b, hq, hkv, sq, skv, d, is_causal, q.dtype, q.device)


def _k1_tiles(key, q, k, fused_block_quant: bool, run) -> int:
    """K1's tile configuration for a call whose key is ``key`` (q and k as
    the kernel takes them; ``run(tiles=i)`` launches it): the cached winner,
    else a sweep where one is asked for (per-block calls, and any call
    inside ``autotune.tuning()``) and allowed, else the default, 0."""
    if key is None:
        return 0
    configs = autotune.K1_TILES[shapes.kernel_width(q.shape[-1])]
    hit = autotune.lookup(key)
    if hit in configs:
        return configs.index(hit)
    if not (fused_block_quant or autotune.tuning_requested()) or not autotune.sweep_allowed(q.device):
        return 0
    cands = autotune.prune_candidates(q.shape[2], k.shape[2], q.shape[-1], q.element_size())
    best = autotune.tune(key, cands, lambda c: functools.partial(run, tiles=configs.index(c)),
                         q.device)
    return configs.index(tuple(best))


def to_16bit(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to bf16, the kernels' operand type; others unchanged."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


flash_attention.launches = 0
flash_attention.window_launches = 0
flash_attention.block_quant_launches = 0
flash_attention.segment_launches = 0
flash_attention.block_mask_launches = 0
flash_attention.int8_v_launches = 0

_SCALING_CODES = {"none": 0, "head": 1, "token": 2}


def _flash_fwd_cuda(q, k, v, scale_q, scale_k, scaling, is_causal, sm_scale, return_residuals,
                    q_offset, out_dtype, window=None, kv_offset=0, tiles=0, *, scale_v=None,
                    q_segment_ids=None, kv_segment_ids=None, bitmap=None):
    """Check what the kernel takes, launch it on the current stream; the
    output in ``out_dtype`` (v's before fp32 was rounded to bf16).
    ``tiles``: the tile configuration, an index into
    ``autotune.K1_TILES[width]``.  ``scale_v``: an int8 v's (B, Hkv, D)
    fp32 scales; ``q_segment_ids`` / ``kv_segment_ids``: (B, Sq) /
    (B, Skv) int32; ``bitmap``: the block mask's granules, bool (the tile
    list is built here, :func:`block_table`).  The three only in
    configuration 0."""
    checks.require_hopper(q.device)
    modes = [t for t in (scale_v, q_segment_ids, kv_segment_ids, bitmap) if t is not None]
    tensors = [q, k, v] + [t for t in (scale_q, scale_k) if t is not None] + modes
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all K1 operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("K1 operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K1's q, k, v must be 16-byte aligned")
    batch, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != batch or k.shape[3] != d:
        raise ValueError(f"bad K/V shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if skv == 0:
        raise ValueError("K1 needs at least one key")
    if q.dtype != k.dtype:
        raise ValueError(f"K1 takes q and k of one dtype, got {q.dtype} and {k.dtype}")
    if checks.is_8bit_dtype(q.dtype) and d % 16:
        raise ValueError(f"K1 takes 8-bit q and k whose head_dim is a multiple of 16, got {d}")
    if scaling == "head" and (
        scale_q.shape != (batch, hq) or scale_k.shape != (batch, hkv)
    ):
        raise ValueError("head-wise scales must be (B, Hq) and (B, Hkv)")
    if scaling == "token" and (
        scale_q.shape != (batch, hq, sq) or scale_k.shape != (batch, hkv, skv)
    ):
        raise ValueError("token-wise scales must be (B, Hq, Sq) and (B, Hkv, Skv)")
    if (v.dtype == torch.int8) != (scale_v is not None):
        raise ValueError("K1 takes an int8 V with its scale_v, and scale_v with an int8 V only")
    if scale_v is not None and (scale_v.dtype != torch.float32 or scale_v.shape != (batch, hkv, d)):
        raise ValueError("K1's scale_v must be (B, Hkv, D) fp32")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("both q/kv segment ids must be provided")
    if q_segment_ids is not None and (
        q_segment_ids.dtype != torch.int32 or kv_segment_ids.dtype != torch.int32
        or q_segment_ids.shape != (batch, sq) or kv_segment_ids.shape != (batch, skv)
    ):
        raise ValueError("K1's segment ids must be (B, Sq) / (B, Skv) int32")
    if not 0 <= tiles < len(autotune.K1_TILES[shapes.kernel_width(d)]):
        raise ValueError(f"K1 has no tile configuration {tiles} at head_dim {d}")
    if modes and tiles != 0:
        raise ValueError(
            f"K1's tile configuration {tiles} takes no segment ids, block mask or int8 V"
        )
    counts = table = cells = None
    if bitmap is not None:
        g = MASK_GRANULE
        if bitmap.dtype != torch.bool or bitmap.shape != (-(-sq // g), -(-skv // g)):
            raise ValueError("K1's block mask must be a (ceil(Sq/128), ceil(Skv/128)) bool bitmap")
        rows, cols = autotune.K1_TILES[shapes.kernel_width(d)][0]
        counts, table = block_table(bitmap, sq, skv, rows, cols, is_causal, window)
        cells = bitmap.to(torch.uint8).contiguous()
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    m = l = None
    if return_residuals:
        m = torch.empty((batch, hq, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    left, right = extents(window)
    lib = _native.library()
    err = lib.qa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if scale_q is None else scale_q.data_ptr(),
        None if scale_k is None else scale_k.data_ptr(),
        out.data_ptr(), batch, hq, hkv, sq, skv, d,
        _native.dtype_code(q.dtype), _native.dtype_code(k.dtype),
        _native.dtype_code(v.dtype),
        _native.F32_OUT_CODE if out_dtype == torch.float32 else _native.dtype_code(out_dtype),
        _SCALING_CODES[scaling], int(bool(is_causal)),
        float(sm_scale * LOG2E), q_offset, kv_offset, left, right,
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(), tiles,
        *(None if t is None else t.data_ptr() for t in (scale_v, q_segment_ids, kv_segment_ids,
                                                        counts, table)),
        0 if table is None else table.shape[1], None if cells is None else cells.data_ptr(),
        0 if cells is None else cells.shape[1], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "qa_flash_fwd")
    flash_attention.launches += 1
    flash_attention.window_launches += window is not None
    flash_attention.segment_launches += q_segment_ids is not None
    flash_attention.block_mask_launches += bitmap is not None
    flash_attention.int8_v_launches += scale_v is not None
    return (out, (m, l)) if return_residuals else out
