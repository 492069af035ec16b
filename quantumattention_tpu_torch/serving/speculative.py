"""Speculative-decoding rejection sampling (counterpart of
quantumattention_tpu/serving/speculative.py; Leviathan et al. 2023, §2).

Greedy rounds accept by argmax equality (in the engine); stochastic rounds
accept proposal x with probability min(1, p(x) / q(x)) and, on rejection,
resample from the residual norm(max(p - q, 0)).  Every emitted token is
then distributed exactly as the target's p: the draft changes how many
target passes a token takes, never its distribution.

A pure function of (generator, probs, proposals) on the device: the engine
owns the caches and the emission.  Its random numbers come from an explicit
``torch.Generator`` where JAX splits a PRNG key, so the two packages draw
different numbers from the same seed; the tests compare distributions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sampling import categorical


def speculative_accept(
    generator: Optional[torch.Generator],
    q_probs: torch.Tensor,
    p_probs: torch.Tensor,
    proposals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized accept / resample for one speculative round.

    generator: the ``torch.Generator`` of the uniforms and the final draw
    (on the tensors' device); q_probs (B, gamma, V) the draft distributions
    each proposal was drawn from (after temperature / top-k / top-p);
    p_probs (B, gamma + 1, V) the target's at the same positions and the
    bonus position; proposals (B, gamma) int tokens, gamma >= 1.

    Returns (n_acc, final), each (B,) int32: the accepted proposals a row
    and the final token (the residual draw at the first rejection, or a
    draw from the bonus distribution when all were accepted).  A round
    emits proposals[:n_acc] + [final].
    """
    batch, gamma = proposals.shape
    idx = proposals.long()[..., None]
    # Accept proposal i iff u_i < p_i(x_i) / q_i(x_i).
    u = torch.rand((batch, gamma), generator=generator, device=p_probs.device)
    p_at = torch.gather(p_probs[:, :gamma], -1, idx)[..., 0]
    q_at = torch.gather(q_probs, -1, idx)[..., 0]
    accept = u < torch.clamp(p_at / torch.clamp(q_at, min=1e-20), max=1.0)
    # The longest accepted prefix: cumprod ignores accepts after a rejection.
    n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(dim=-1)
    # The residual at the first rejection, or the untouched bonus p when
    # every proposal was accepted.
    at = torch.clamp(n_acc, max=gamma - 1).long()[:, None, None].expand(-1, 1, p_probs.shape[-1])
    p_rej = torch.gather(p_probs, 1, at)[:, 0]
    q_rej = torch.gather(q_probs, 1, at)[:, 0]
    residual = torch.clamp(p_rej - q_rej, min=0.0)
    # q == p exactly leaves an all-zero residual, but then a rejection has
    # probability 0; normalize safely anyway.
    residual = residual / torch.clamp(residual.sum(dim=-1, keepdim=True), min=1e-20)
    final_dist = torch.where((n_acc == gamma)[:, None], p_probs[:, gamma], residual)
    final = categorical(final_dist, generator)
    return n_acc.to(torch.int32), final.to(torch.int32)
