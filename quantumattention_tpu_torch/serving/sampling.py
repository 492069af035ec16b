"""Token sampling for the serving engine (counterpart of
quantumattention_tpu/serving/sampling.py).  Categorical draws take a
``torch.Generator`` where the JAX package takes a PRNG key."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.top_p is not None and not (0 < self.top_p <= 1):
            raise ValueError("top_p must be in (0, 1]")


def filtered_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Apply temperature / top-k / top-p to (B, V) fp32 logits."""
    if params.temperature == 0.0:
        raise ValueError("filtered_logits requires temperature > 0")
    logits = logits / params.temperature
    if params.top_k is not None:
        top_k = min(params.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest prefix with cumulative mass >= top_p.
        cutoff_idx = torch.argmax((cum >= params.top_p).to(torch.int32), dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def filtered_probs(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """(B, V) fp32 logits -> the post-filter probability distribution."""
    return torch.softmax(filtered_logits(logits, params), dim=-1)


def categorical(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw a row of (B, V) probabilities, as int64, on the device.

    argmax(p / E), E ~ Exp(1): the draw torch.multinomial makes for one
    sample, without its host-side check of the probabilities, so a decode
    step that samples can be captured in a CUDA graph."""
    race = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / race, dim=-1)


def sample(
    logits: torch.Tensor, params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, V) fp32 logits -> (B,) int32 token ids."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    return categorical(filtered_probs(logits, params), generator).to(torch.int32)


def sample_with_logprob(
    logits: torch.Tensor, params: SamplingParams,
    generator: Optional[torch.Generator] = None,
):
    """(B, V) fp32 logits -> ((B,) int32 tokens, (B,) fp32 logprobs), the
    logprob taken under the distribution the token was drawn from."""
    toks = sample(logits, params, generator)
    if params.temperature == 0.0:
        dist = torch.log_softmax(logits, dim=-1)
    else:
        dist = torch.log_softmax(filtered_logits(logits, params), dim=-1)
    lps = torch.gather(dist, -1, toks.long()[:, None])[:, 0]
    return toks, lps
