"""Expert parallelism: GShard-style all-to-all dispatch over an ``ep`` axis
(counterpart of quantumattention_tpu/parallel/ep.py).

Tokens split over the axis by batch, experts by their leading E axis.
Each rank routes its own tokens against all experts and builds the dense
(E, C_local, H) dispatch batch (``models/moe.moe_ffn``); one all-to-all
swaps the expert axis for the capacity axis, so each rank holds its
experts' token groups from every rank, (E / n, n C_local, H); the local
experts run (int8 stacks through K5/K6, one launch an expert,
``models/quantized._expert_matmul``); a mirrored all-to-all sends the
results home.  Capacity is per rank (C_local from the rank's own tokens),
so drops are decided locally; with a capacity factor at which nothing
drops, the result equals the single-device ``moe_ffn``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import moe as moe_lib
from .mesh import P, all_to_all, axis_size, quantized_specs, shard, shard_params

Params = Dict[str, Any]


def moe_param_specs(axis_name: str = "ep") -> Params:
    """Specs of ``models/moe.init_moe_params`` under EP: the router
    replicated, the expert stacks split on their leading E axis."""
    return {
        "w_router": P(),
        "w_gate": P(axis_name),
        "w_up": P(axis_name),
        "w_down": P(axis_name),
    }


def expert_parallel_ffn(
    moe: Params,
    x: torch.Tensor,
    *,
    mesh,
    axis_name: str = "ep",
    num_experts_per_tok: int = 2,
    capacity_factor: float = 2.0,
) -> torch.Tensor:
    """Sparse MoE FFN with experts sharded over ``axis_name``.

    ``moe``: the router (H, E) and the expert stacks, either of all E
    experts (sliced here) or of this rank's E / n (as ``shard_params(moe,
    mesh, moe_param_specs(axis_name))`` gives them; int8 {"q", "s"} stacks
    too).  x (B, S, H): the whole batch, the same on every rank.  Returns
    this rank's batch rows of the output, (B / n, S, H)."""
    n = axis_size(mesh, axis_name)
    num_experts = moe["w_router"].shape[-1]
    if num_experts % n != 0:
        raise ValueError(
            f"num_experts ({num_experts}) must be divisible by the ep axis "
            f"size ({n})"
        )
    if x.shape[0] % n != 0:
        raise ValueError(
            f"batch ({x.shape[0]}) must be divisible by the ep axis size "
            f"({n})"
        )
    stack = moe["w_gate"]["q"] if isinstance(moe["w_gate"], dict) else moe["w_gate"]
    if stack.shape[0] == num_experts and n > 1:
        moe = shard_params(moe, mesh, quantized_specs(moe, moe_param_specs(axis_name)))

    def ep_expert_fn(moe_local, x_e):
        # x_e (E, C_local, H): this rank's tokens dispatched to all experts.
        xs = all_to_all(x_e, mesh, axis_name, split_dim=0, concat_dim=1)
        ys = moe_lib.expert_ffn(moe_local, xs)
        return all_to_all(ys, mesh, axis_name, split_dim=1, concat_dim=0)

    return moe_lib.moe_ffn(
        moe, shard(x, mesh, axis_name, 0), num_experts_per_tok=num_experts_per_tok,
        capacity_factor=capacity_factor, expert_fn=ep_expert_fn,
    )
