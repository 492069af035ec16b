"""Pipeline parallelism: GPipe microbatch streaming over a mesh axis
(counterpart of quantumattention_tpu/parallel/pp.py).

Stages sit along a ``pp`` axis, one a rank; activations go from stage r to
stage r + 1 by a send/receive each tick, and microbatches stream through
the fill / steady / drain schedule of n_micro + n_stages - 1 ticks.  Stage
parameters are a stacked tree, every leaf with a leading ``n_stages``
axis; each rank takes its own index.  A stage runs only in the ticks that
hold one of its microbatches (JAX's stages compute on zeros in the fill
and drain ticks, whose results the schedule drops).  The last stage's
outputs are broadcast, so every rank returns them all.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import axis_rank, axis_size, broadcast, shift


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    mesh,
    axis_name: str = "pp",
) -> torch.Tensor:
    """Run ``n_stages`` chained applications of ``stage_fn`` as a pipeline.

    ``stage_fn(params_slice, activation) -> activation`` is one stage and
    keeps the activation's shape and dtype; ``stacked_params`` holds every
    stage (leaf[i] is stage i's); ``x`` (n_micro, microbatch, ...) is the
    same on every rank.  Returns (n_micro, microbatch, ...), the stages
    applied in sequence to every microbatch, on every rank."""
    n, rank = axis_size(mesh, axis_name), axis_rank(mesh, axis_name)
    p = _index(stacked_params, rank)
    n_micro = x.shape[0]
    act = torch.zeros_like(x[0])
    out = torch.zeros_like(x)
    for t in range(n_micro + n - 1):
        mi = t - rank  # the microbatch this stage holds at tick t
        y = act
        if 0 <= mi < n_micro:
            y = stage_fn(p, x[mi] if rank == 0 else act)
            if rank == n - 1:
                out[mi] = y
        if t + 1 < n_micro + n - 1:
            (act,) = shift([y], mesh, axis_name, wrap=False)
    return broadcast(out, mesh, axis_name, src=n - 1)
