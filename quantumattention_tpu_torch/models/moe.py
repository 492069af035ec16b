"""Mixture-of-Experts FFN, Mixtral style (counterpart of
quantumattention_tpu/models/moe.py).

GShard dense dispatch, as in the JAX package: routing, dispatch and combine
are one-hot products of static shape (tokens x experts x capacity), tokens
past an expert's capacity are dropped (their combine weight is zero, so the
residual carries them through), and the expert axis leads every weight
stack.  The router is the top-k of fp32 logits with the gates renormalized
over the k choices (softmax over the chosen logits); the Switch/GShard
load-balancing loss and the router z-loss are separate functions.

Numerics follow the JAX module exactly, since parity depends on them: the
router product in fp32 (``torch.matmul`` on fp32 tensors, which is true
fp32 under PyTorch's default precision; a caller who turns TF32 on changes
routing), capacity claimed slot-major by an exclusive cumsum (every
token's first choice before any second choice), dispatch 0/1 in bf16,
combine in fp32 cast to the experts' output dtype before the combine
product.

Nothing here synchronises with the host, so a decode step with an MoE
layer captures in a CUDA graph: one-hots are comparisons against an
``arange`` (``F.one_hot`` takes int64 only and returns int64), and top-k,
softmax and cumsum stay on the device.  Dispatch and combine are plain
PyTorch products, as JAX computes them outside any Pallas kernel; the
expert products go through ``models/quantized.matmul``, which sends an
int8 stack through K5/K6 one expert at a time on the card.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(...) integer ids -> (..., n) fp32 0/1, with no host round trip."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def router_topk(router_logits: torch.Tensor, num_experts_per_tok: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, E) fp32 logits -> gates (N, k) fp32, the softmax over the k
    chosen logits, and experts (N, k) int32, best first."""
    top_logits, experts = torch.topk(router_logits, num_experts_per_tok, dim=-1)
    return torch.softmax(top_logits, dim=-1), experts.to(torch.int32)


def expert_capacity(num_tokens: int, num_experts: int, num_experts_per_tok: int,
                    capacity_factor: float) -> int:
    """Per-expert token capacity, rounded up to a multiple of 8, at least 8."""
    raw = math.ceil(capacity_factor * num_experts_per_tok * num_tokens / num_experts)
    return max(8, -(-raw // 8) * 8)


def make_dispatch_combine(gates: torch.Tensor, experts: torch.Tensor, num_experts: int,
                          capacity: int, offsets: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch and combine tensors (GShard §3.1).

    A (choice, token) assignment takes the next free slot of its expert in
    slot-major order, so all tokens' first choices claim capacity before
    any second choice (the Switch priority rule); past ``capacity`` it is
    dropped.  ``offsets`` (k, E): slots of each expert taken ahead of this
    batch's assignments of each choice by other ranks' tokens
    (:func:`queue_offsets`).  Returns dispatch (N, E, C) bf16 0/1 and
    combine (N, E, C) fp32, dispatch weighted by the gate."""
    n, k = gates.shape
    onehot_km = _one_hot(experts, num_experts).transpose(0, 1)  # (k, N, E)
    flat = onehot_km.reshape(k * n, num_experts)
    pos_flat = torch.cumsum(flat, dim=0) - flat  # exclusive cumsum
    if offsets is not None:
        pos_flat = pos_flat + offsets[:, None, :].expand(k, n, num_experts).reshape(k * n, num_experts)
    kept_flat = flat * (pos_flat < capacity)
    pos = pos_flat.reshape(k, n, num_experts)
    kept = kept_flat.reshape(k, n, num_experts)
    pos_onehot = _one_hot((pos * kept).sum(dim=-1).to(torch.int64), capacity)  # (k, N, C)
    dispatch = torch.einsum("kne,knc->nec", kept, pos_onehot)
    combine = torch.einsum("kne,knc,kn->nec", kept, pos_onehot, gates.t().float())
    return dispatch.to(torch.bfloat16), combine


def queue_offsets(experts: torch.Tensor, num_experts: int, dp) -> torch.Tensor:
    """Each expert's slots claimed before this rank's assignments of each
    choice, when the batch is split by rows over the data-parallel axis
    ``dp`` (a ``parallel/mesh.Axis``; rank r holds the r-th block of rows):
    the whole batch's queue is choice-major, then rank, then token, so
    choice j here follows every rank's earlier choices and the lower ranks'
    choice j.  Returns (k, E) fp32 counts, less the earlier choices this
    rank's own cumsum already counts."""
    counts = _one_hot(experts, num_experts).sum(dim=0)  # (k, E)
    every = dp.all_gather(counts[None], dim=0)  # (ranks, k, E)
    total = every.sum(dim=0)
    earlier_choices = torch.cumsum(total, dim=0) - total
    own_earlier = torch.cumsum(counts, dim=0) - counts
    return earlier_choices - own_earlier + every[: dp.rank].sum(dim=0)


def load_balancing_loss(router_probs: torch.Tensor, experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary loss: E * <fraction routed> . <mean
    prob> / k; 1.0 under perfectly uniform routing."""
    frac_routed = _one_hot(experts, num_experts).sum(dim=1).mean(dim=0)
    mean_prob = router_probs.mean(dim=0)
    return num_experts * torch.sum(frac_routed * mean_prob) / experts.shape[1]


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE z-loss: the mean squared logsumexp of the router logits."""
    z = torch.logsumexp(router_logits, dim=-1)
    return torch.mean(z * z)


# ---------------------------------------------------------------------------
# Expert FFN
# ---------------------------------------------------------------------------


def init_moe_params(
    generator: torch.Generator, hidden_size: int, intermediate_size: int, num_experts: int,
    dtype: Any = torch.bfloat16, device=None, *,
    transform: Optional[Callable[[str, torch.Tensor], Any]] = None,
) -> Params:
    """Router (H, E) fp32 and SwiGLU expert stacks, E leading: truncated
    normal in [-3, 3] over sqrt(fan_in), drawn from ``generator`` in the
    JAX order (router, gate, up, down).  ``transform(name, w)`` replaces
    each stack as soon as it is drawn (the router stays fp32)."""
    device = torch.device(device if device is not None else generator.device)
    e, h, i = num_experts, hidden_size, intermediate_size

    def draw(shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        return w.div_(math.sqrt(shape[-2]))

    out: Params = {"w_router": draw((h, e))}
    for name, shape in (("w_gate", (e, h, i)), ("w_up", (e, h, i)), ("w_down", (e, i, h))):
        w = draw(shape).to(dtype)
        out[name] = transform(name, w) if transform is not None else w
    return out


def expert_ffn(moe: Params, x_e: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over per-expert token groups: (E, C, H) -> (E, C, H)."""
    from . import quantized

    gate = quantized.matmul(x_e, moe["w_gate"])
    up = quantized.matmul(x_e, moe["w_up"])
    act = F.silu(gate.float()).to(x_e.dtype) * up
    return quantized.matmul(act, moe["w_down"])


def moe_ffn(
    moe: Params, x: torch.Tensor, *, num_experts_per_tok: int, capacity_factor: float = 1.25,
    expert_fn=None, return_aux: bool = False, dp=None,
):
    """Sparse MoE feed-forward over (..., H) activations.

    Capacity is computed over every row of ``x``, in its flattened order.
    ``expert_fn(moe, x_e)`` computes the experts on the dispatched (E, C, H)
    batch (default :func:`expert_ffn`).  With ``return_aux`` also returns
    the load-balancing loss and the router z-loss.  ``dp``: the
    data-parallel axis when ``x`` is this rank's block of a batch split
    by rows (training on a mesh): capacity and each token's place in an
    expert's queue are then the whole batch's (:func:`queue_offsets`), as
    GSPMD computes them in JAX, and the expert batch has the whole batch's
    capacity, the slots of other ranks' tokens left zero."""
    orig_shape = x.shape
    xt = x.reshape(-1, x.shape[-1])
    n = xt.shape[0]
    e = moe["w_router"].shape[-1]

    router_logits = torch.matmul(xt.float(), moe["w_router"])
    gates, experts = router_topk(router_logits, num_experts_per_tok)
    ranks = 1 if dp is None else dp.size
    cap = expert_capacity(n * ranks, e, num_experts_per_tok, capacity_factor)
    offsets = None if dp is None else queue_offsets(experts, e, dp)
    dispatch, combine = make_dispatch_combine(gates, experts, e, cap, offsets)

    x_e = torch.einsum("nec,nh->ech", dispatch.to(x.dtype), xt).contiguous()
    y_e = (expert_fn or expert_ffn)(moe, x_e)
    y = torch.einsum("nec,ech->nh", combine.to(y_e.dtype), y_e).reshape(orig_shape)
    if not return_aux:
        return y
    probs = torch.softmax(router_logits, dim=-1)
    aux = {
        "load_balancing_loss": load_balancing_loss(probs, experts, e),
        "router_z_loss": router_z_loss(router_logits),
    }
    return y, aux
