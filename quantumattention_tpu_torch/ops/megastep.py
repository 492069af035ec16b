"""Fused decode layer (counterpart of quantumattention_tpu/ops/megastep.py).

``fused_decode_layer`` is the wrapper of kernel K9 (``csrc/megastep.cu``,
the port of the Pallas ``_mega_kernel``, megastep.py:72): one C call runs
a whole decode layer over the int8 slot cache -- attention (one CTA per KV
head and slot), then K8's stages on the tail product (``ops/qmlp``): the wo
product with the residual and RMSNorm in its reduction, the SwiGLU MLP and,
optionally, the next layer's RMSNorm + QKV projection -- as a fixed
sequence of hand-written kernels with no PyTorch op between them.  A CPU
tensor runs the plain version, :func:`fused_decode_layer_plain`; a CUDA
tensor runs the kernel or raises.  ``fused_decode_layer.launches`` counts
calls (``.window_launches`` those with a window),
``fused_decode_layer.last_kernels`` the kernels the last call launched on
the card.

The kernel attends over the POST-append cache: the caller writes the
current token first (``serving/kv_cache.append_quantized_token``), and the
step context carries the post-append lengths.  Where the TPU kernel takes
its bounds as a (B, S) additive column mask, a (B, 128) row-zero mask and a
prefetched block count (``build_decode_ctx``, megastep.py:326-360), the
card's kernel reads each slot's length (and the window) and skips the rows
outside them itself, so nothing in the context is read back to the host and
a decode step can be captured in a CUDA graph.  :func:`decode_masks`
rebuilds the JAX masks from the context for the plain version and the
tests.

The gate keeps the JAX structure checks (megastep.py:378-411).  The Mosaic
VMEM terms (``_pick_bkv``, ``_pick_tile``, ``_side_bytes``,
``_VMEM_BUDGET``) size TPU blocks and are not carried over; the card's own
limit is the query group (at most 8 query heads per KV head: the group's
rows share one mma.sync tile).  The burst
side buffer (``side=``, ``flush_side``) is a TPU workaround and is not
ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Optional

import torch

from .. import config
from ..utils import checks
from . import _native
from .qmlp import fused_layer_tail_plain
from .qmm import check_activation, check_weight
from .sdpa import DEFAULT_MASK_VALUE

LOG2E = math.log2(math.e)
#: Query heads per KV head that K9 takes (csrc/megastep.cu, kMaxGroup).
MAX_GROUP = 8


def _is_q8(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def megastep_supported(cfg, params, cache, batch: int, mesh=None, side_tokens: int = 0) -> bool:
    """Routing gate of the fused decode layer step.

    Requires the fused int8 w8a16 tree (``w_qkv``/``w_gate_up``/``w_down``/
    ``wo`` all {"q","s"}), an int8 token-wise-scaled slot cache, head_dim
    128, bf16, no QKV biases / MoE / mesh, 128-multiple widths, a batch that
    is a multiple of 16 and at most 256, and at most ``MAX_GROUP`` query
    heads per KV head.  ``config.kernel.megastep``: True routes a cache on
    a CUDA device, "force" also one on the CPU (through the plain version),
    False none."""
    flag = config.kernel.megastep
    if not flag or mesh is not None:
        return False
    if not checks.kernel_route(flag, cache.k.device):
        return False
    if cfg.qkv_bias or cfg.num_experts > 0:
        return False
    if cfg.window is not None and cfg.window - 1 < side_tokens:
        return False
    if cfg.head_dim != 128 or cfg.dtype != torch.bfloat16:
        return False
    if cache.k.dtype != torch.int8 or cache.k_scale is None:
        return False
    if cache.k.shape[-1] != cfg.head_dim:  # packed int4 container
        return False
    layers = params["layers"]
    if not all(
        all(_is_q8(layer.get(k)) for k in ("w_qkv", "w_gate_up", "w_down", "wo"))
        for layer in layers
    ):
        return False
    e_dim, inter, q_dim = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    f_out = layers[0]["w_qkv"]["q"].shape[1]
    if any(x % 128 for x in (e_dim, inter, q_dim, f_out)):
        return False
    if batch % 16 or batch > 256:
        return False
    if cfg.num_q_heads % cfg.num_kv_heads:
        return False
    return cfg.num_q_heads // cfg.num_kv_heads <= MAX_GROUP


def build_decode_ctx(
    positions: torch.Tensor, active_mask: torch.Tensor, s_max: int, bkv: Optional[int] = None,
    window_left: Optional[int] = None,
) -> Dict[str, Any]:
    """Per-step context shared by every layer's K9 call: the post-append
    lengths (positions + active, on the device) and the window extent
    (``cfg.window - 1``; the query at position lengths - 1 sees rows from
    lengths - 1 - window_left on).  ``bkv``, the Mosaic cache block, is
    accepted for the JAX signature; the card's kernel tiles 32 rows."""
    del bkv
    lengths = positions.to(torch.int32) + active_mask.to(torch.int32)
    return {"lengths": lengths, "s_max": s_max, "window_left": window_left}


def decode_masks(step_ctx: Dict[str, Any]):
    """The JAX context's (B, S) additive column mask and (B,) row-zero
    mask, rebuilt from the port's context (megastep.py:340-353)."""
    lengths = step_ctx["lengths"]
    cols = torch.arange(step_ctx["s_max"], dtype=torch.int32, device=lengths.device)[None, :]
    keep = cols < lengths[:, None]
    if step_ctx["window_left"] is not None:
        keep = keep & (cols >= (lengths - 1 - step_ctx["window_left"])[:, None])
    cmask = torch.where(keep, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
    return cmask, (lengths > 0).to(torch.float32)


def fused_decode_layer_plain(
    x, q, cache_k, cache_v, cache_ks, cache_vs, step_ctx, layer,
    next_attn_norm=None, next_w_qkv=None, *, eps, sm_scale=None,
):
    """K9's plain version in fp32 with its rounding points: scores times
    sm_scale * log2(e) times the K scale plus the column mask, exp2
    softmax, P times the V scale rounded to bf16, the normalized head
    output rounded to x.dtype; then K8's plain tail with that output and
    wo (``qmlp.fused_layer_tail_plain``)."""
    batch, hq, d = q.shape
    hkv = cache_k.shape[1]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    cmask, auxz = decode_masks(step_ctx)
    qg = q.float().reshape(batch, hkv, group, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, cache_k.float()) * (sm_scale * LOG2E)
    s = s * cache_ks.float()[:, :, None, :] + cmask[:, None, None, :]
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p_eff = (p * cache_vs.float()[:, :, None, :]).to(torch.bfloat16).float()
    acc = torch.einsum("bhgs,bhsd->bhgd", p_eff, cache_v.float())
    l_inv = torch.where(l == 0.0, 0.0, 1.0 / l)
    attn = (acc * l_inv * auxz[:, None, None, None]).to(x.dtype).reshape(batch, hq * d)
    return fused_layer_tail_plain(
        x, layer["mlp_norm"], layer["w_gate_up"], layer["w_down"], eps=eps,
        attn_out=attn, wo=layer["wo"], next_attn_norm=next_attn_norm, next_w_qkv=next_w_qkv,
    )


def fused_decode_layer(
    x: torch.Tensor,
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cache_ks: torch.Tensor,
    cache_vs: torch.Tensor,
    step_ctx: Dict[str, Any],
    layer: Dict[str, Any],
    next_attn_norm: Optional[torch.Tensor] = None,
    next_w_qkv: Optional[Dict[str, torch.Tensor]] = None,
    *,
    side=None,
    eps: float,
    sm_scale: Optional[float] = None,
):
    """One fused decode layer step (see the module docstring).

    x (B, E) bf16 residual stream; q (B, Hq, D) bf16 rotated queries;
    cache_* this layer's slot cache ((B, Hkv, S, D) int8 and (B, Hkv, S)
    fp32 scales) with the current token already written; step_ctx from
    :func:`build_decode_ctx`; layer the fused w8a16 layer dict (wo,
    mlp_norm, w_gate_up, w_down); next_attn_norm/next_w_qkv the NEXT
    layer's RMSNorm weight and fused QKV matrix.

    Returns (x_out (B, E), qkv_next (B, F) pre-RoPE, or None)."""
    if side is not None:
        raise NotImplementedError(
            "fused_decode_layer: the burst side buffer is a TPU workaround and is "
            "not ported (ROADMAP, 'Do not port these TPU workarounds'); append "
            "to the cache first and attend over it"
        )
    if (next_attn_norm is None) != (next_w_qkv is None):
        raise ValueError("next_attn_norm and next_w_qkv must be given together")
    batch, hq, d = q.shape
    if cache_k.ndim != 4 or cache_k.shape != cache_v.shape or cache_k.shape[0] != batch:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not match q {tuple(q.shape)}")
    hkv, s_max = cache_k.shape[1], cache_k.shape[2]
    if hq % hkv or cache_k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(cache_k.shape)}")
    if cache_ks.shape != (batch, hkv, s_max) or cache_vs.shape != cache_ks.shape:
        raise ValueError("cache scales must be (B, Hkv, S)")
    if x.shape[0] != batch or layer["wo"]["q"].shape != (hq * d, x.shape[1]):
        raise ValueError(f"x {tuple(x.shape)} and wo do not match q {tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (x, q, cache_k, cache_v, cache_ks, cache_vs, step_ctx, layer, next_attn_norm, next_w_qkv)
    if x.device.type == "cpu":
        out = fused_decode_layer_plain(*args, eps=eps, sm_scale=sm_scale)
    else:
        out = _mega_cuda(*args, eps=eps, sm_scale=sm_scale)
    return out if next_w_qkv is not None else (out, None)


fused_decode_layer.launches = 0
fused_decode_layer.window_launches = 0
fused_decode_layer.last_kernels = 0


def _mega_cuda(x, q, cache_k, cache_v, cache_ks, cache_vs, step_ctx, layer,
               next_attn_norm, next_w_qkv, *, eps, sm_scale):
    """Check what K9 takes, allocate its workspace, launch."""
    dev = x.device
    checks.require_hopper(dev)
    check_activation(x, "K9", (torch.bfloat16,))
    check_activation(q, "K9 q", (torch.bfloat16,))
    batch, hq, d = q.shape
    _, hkv, s_max, _ = cache_k.shape
    e_dim = x.shape[1]
    lengths = step_ctx["lengths"]
    if d != 128 or hq // hkv > MAX_GROUP:
        raise ValueError(f"K9 needs head_dim 128 and at most {MAX_GROUP} query heads per KV head")
    for t, name in ((cache_k, "cache k"), (cache_v, "cache v")):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"K9 {name}: contiguous 16-byte-aligned int8 on {dev}")
    for t, name in ((cache_ks, "k scales"), (cache_vs, "v scales")):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"K9 {name}: contiguous float32 on {dev}")
    if (lengths.dtype != torch.int32 or lengths.shape != (batch,) or not lengths.is_contiguous()
            or lengths.device != dev):
        raise ValueError(f"K9 lengths: contiguous int32 ({batch},) on {dev}")
    for v in (layer["mlp_norm"], next_attn_norm):
        if v is not None and (v.dtype != torch.float32 or not v.is_contiguous() or v.device != dev):
            raise ValueError("K9's norm weights must be contiguous float32 on the card")
    mats = [(layer["wo"], "wo"), (layer["w_gate_up"], "w_gate_up"), (layer["w_down"], "w_down")]
    if next_w_qkv is not None:
        mats.append((next_w_qkv, "w_qkv"))
    for w, name in mats:
        if not _is_q8(w):
            raise ValueError(f"K9 takes int8 {{'q', 's'}} matrices; {name} is not one")
        check_weight(w["q"], w["s"], dev, f"K9 {name}")
    inter = layer["w_down"]["q"].shape[0]
    f_out = 0 if next_w_qkv is None else next_w_qkv["q"].shape[1]
    if (layer["w_gate_up"]["q"].shape != (e_dim, 2 * inter) or layer["w_down"]["q"].shape[1] != e_dim
            or (next_w_qkv is not None and next_w_qkv["q"].shape[0] != e_dim)):
        raise ValueError("K9: w_gate_up, w_down and w_qkv do not match x")
    if e_dim % 128 or inter % 128 or f_out % 128:
        raise ValueError(f"K9 needs E, I, F % 128 == 0: E={e_dim} I={inter} F={f_out}")
    window = step_ctx["window_left"]
    out = torch.empty_like(x)
    qkv = torch.empty((batch, f_out), dtype=x.dtype, device=dev) if f_out else None
    if batch == 0:
        return out if qkv is None else (out, qkv)
    lib = _native.library()
    attn = torch.empty((batch, hq * d), dtype=x.dtype, device=dev)
    x1 = torch.empty_like(x)
    h = torch.empty_like(x)
    act = torch.empty((batch, inter), dtype=x.dtype, device=dev)
    partial = torch.empty(
        (lib.qa_decode_layer_workspace(batch, hq * d, e_dim, inter, f_out),),
        dtype=torch.float32, device=dev,
    )
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    nq = next_w_qkv or {}
    kernels = ctypes.c_int(0)
    err = lib.qa_decode_layer(
        x.data_ptr(), q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        cache_ks.data_ptr(), cache_vs.data_ptr(), lengths.data_ptr(),
        -1 if window is None else int(window),
        layer["wo"]["q"].data_ptr(), layer["wo"]["s"].data_ptr(), layer["mlp_norm"].data_ptr(),
        layer["w_gate_up"]["q"].data_ptr(), layer["w_gate_up"]["s"].data_ptr(),
        layer["w_down"]["q"].data_ptr(), layer["w_down"]["s"].data_ptr(),
        ptr(next_attn_norm), ptr(nq.get("q")), ptr(nq.get("s")),
        out.data_ptr(), ptr(qkv), attn.data_ptr(), x1.data_ptr(), h.data_ptr(), act.data_ptr(),
        partial.data_ptr(), batch, hq, hkv, s_max, d, e_dim, inter, f_out,
        float(sm_scale * LOG2E), float(eps), ctypes.byref(kernels),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _native.check(err, "qa_decode_layer")
    fused_decode_layer.launches += 1
    fused_decode_layer.window_launches += window is not None
    fused_decode_layer.last_kernels = kernels.value
    return out if qkv is None else (out, qkv)
