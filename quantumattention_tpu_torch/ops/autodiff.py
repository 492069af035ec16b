"""Differentiable attention (counterpart of quantumattention_tpu/ops/autodiff.py).

:func:`attention_with_vjp` is a ``torch.autograd.Function`` around the fused
forward K1, the counterpart of the JAX ``custom_vjp`` (autodiff.py:41-110).
With ``config.kernel.cuda_bwd`` (the default) the forward also returns the
online-softmax residuals (m, l), and the backward runs the blockwise
kernels K2/K3 (ops/flash_bwd.py); with it off, the forward saves only
(q, k, v) and the backward is autograd through the fp32 SDPA oracle (the
O(S^2) recompute, autodiff.py:73-107).

The Function runs where autograd records (grad mode on and an input that
requires grad); elsewhere the call is the plain forward, so serving pays
for no residuals.  A CPU tensor and a CUDA tensor take the same path: the
kernels' wrappers pick the plain version or the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config
from .flash import flash_attention, kernel_window
from .flash_bwd import flash_attention_bwd
from .sdpa import sdpa_reference


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def oracle_vjp(q, k, v, grad_out, is_causal: bool, sm_scale: Optional[float], window=None):
    """(dq, dk, dv) of exact attention at (q, k, v): autograd through the
    fp32 oracle, the right window extent dropped under ``is_causal`` as the
    kernels drop it (autodiff.py:73-87).  GQA gradients sum over each group
    through its repeat."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = sdpa_reference(qd, kd, vd, is_causal=is_causal, scale=sm_scale,
                             window=kernel_window(window, is_causal), out_dtype=v.dtype)
        return torch.autograd.grad(out, (qd, kd, vd), grad_out.to(out.dtype))


def exact_attention_bwd(q, k, v, grad_out, is_causal: bool, sm_scale: Optional[float],
                        window=None):
    """Gradient of exact attention at (q, k, v), recomputing the forward:
    K1 with residuals, then K2/K3, or the oracle VJP without cuda_bwd."""
    if not config.kernel.cuda_bwd:
        return oracle_vjp(q, k, v, grad_out, is_causal, sm_scale, window)
    out, (m, l) = flash_attention(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, return_residuals=True, window=window
    )
    return flash_attention_bwd(
        q, k, v, out, grad_out.to(out.dtype), m, l, is_causal=is_causal, sm_scale=sm_scale,
        window=window,
    )


class FlashAttention(torch.autograd.Function):
    """K1 forward; K2/K3 (or oracle) backward."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, sm_scale, window):
        ctx.is_causal, ctx.sm_scale, ctx.window = is_causal, sm_scale, window
        if config.kernel.cuda_bwd:
            out, (m, l) = flash_attention(
                q, k, v, is_causal=is_causal, sm_scale=sm_scale, return_residuals=True,
                window=window,
            )
            ctx.save_for_backward(q, k, v, out, m, l)
        else:
            out = flash_attention(q, k, v, is_causal=is_causal, sm_scale=sm_scale, window=window)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        if len(saved) == 6:
            q, k, v, out, m, l = saved
            grads = flash_attention_bwd(
                q, k, v, out, grad_out.to(out.dtype), m, l,
                is_causal=ctx.is_causal, sm_scale=ctx.sm_scale, window=ctx.window,
            )
        else:
            grads = oracle_vjp(*saved, grad_out, ctx.is_causal, ctx.sm_scale, ctx.window)
        return (*grads, None, None, None)


def attention_with_vjp(
    q, k, v, *, is_causal: bool = False, sm_scale: Optional[float] = None, window=None
):
    """Fused-forward attention with gradients to q, k and v (GQA gradients
    summed over each group).  Same contract as ``flash_attention`` for
    bf16/fp16 inputs, ``window`` included."""
    if not needs_grad(q, k, v):
        return flash_attention(q, k, v, is_causal=is_causal, sm_scale=sm_scale, window=window)
    return FlashAttention.apply(q, k, v, is_causal, sm_scale, window)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quantize_fn, t):
        ctx.dtype = t.dtype
        values, scale = quantize_fn(t)
        ctx.mark_non_differentiable(scale)
        return values, scale

    @staticmethod
    def backward(ctx, grad_values, _grad_scale):
        return None, grad_values.to(ctx.dtype)


def quantize_ste(quantize_fn, t):
    """Straight-through estimator around a quantizer (autodiff.py:140-160).

    Forward: ``quantize_fn(t) -> (t_q, scale)``.  Backward: the gradient of
    ``t_q`` passes to ``t`` unchanged (cast to t's dtype); the scale takes
    no gradient.
    """
    return _QuantizeSTE.apply(quantize_fn, t)
