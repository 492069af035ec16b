"""Cache backend of the continuous-batching engine (counterpart of
quantumattention_tpu/serving/backends.py).

``SlotsBackend`` owns one ``kv_cache.KVCache`` per layer, contiguous rows
(num_slots, Hkv, max_len, D) per slot, and everything that reads or writes
them: the prefill forward with its cache writes, the decode step over all
slots through the decode kernel (ops/decode.py), and slot release.

Not ported: the paged backend (ROADMAP queue 1, item 17), chunked prefill,
on-device decode bursts, speculative verification and tensor-parallel
meshes (items 15 and 19).  Buffer donation is not ported either: it exists
for JAX's immutable arrays, and the PyTorch cache is updated in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models import llama
from ..ops.decode import decode_attention
from . import kv_cache as kvc


class SlotsBackend:
    """Contiguous slot cache: one (Hkv, max_len, D) row region per slot."""

    name = "slots"

    def __init__(
        self, cfg: llama.LlamaConfig, *, num_slots: int, max_len: int,
        cache_dtype=torch.int8, device=None,
    ) -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = torch.device(device if device is not None else "cpu")
        self.caches = [
            kvc.init_cache(
                num_slots, cfg.num_kv_heads, max_len, cfg.head_dim,
                cache_dtype, device=self.device,
            )
            for _ in range(cfg.num_layers)
        ]
        self._slot_ids = torch.arange(num_slots, dtype=torch.int64, device=self.device)

    # -- admission (slot rows are pre-sized to max_len) -----------------------

    def check_submit(self, reservation: int) -> None:
        pass

    def try_admit(self, req, slot: int, reservation: int) -> Optional[int]:
        return 0  # storage pre-exists; no reservation, no prefix reuse

    def register_prefix(self, req) -> None:
        pass

    # -- prefill ---------------------------------------------------------------

    def _tensor(self, values, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(list(values), dtype=dtype, device=self.device)

    def write_prefill_batch(
        self, kv, slots: Sequence[int], n_valid: Sequence[int], padded: int
    ) -> None:
        """Write a batched prefill's per-layer post-RoPE K/V into the slots."""
        slot_arr = self._tensor(slots)
        zeros = torch.zeros_like(slot_arr)
        nvals = self._tensor(n_valid)
        for cache, (k, v) in zip(self.caches, kv):
            kvc.append(cache, slot_arr, k.float(), v.float(), zeros, nvals)

    def prefill_and_write(
        self, prefill_fn, params, tokens, last_pos,
        slots: Sequence[int], n_valid: Sequence[int], padded: int,
    ) -> torch.Tensor:
        """Whole-prompt prefill forward, then every layer's cache writes.
        Returns the last-position logits (B, vocab)."""
        logits, kv = prefill_fn(params, tokens, last_pos=self._tensor(last_pos))
        self.write_prefill_batch(kv, slots, n_valid, padded)
        return logits

    # -- decode ----------------------------------------------------------------

    @torch.no_grad()
    def decode(self, params, tokens, active_mask, active_slots=None) -> torch.Tensor:
        """One decode step over all slots: append each slot's token K/V
        (length bumped only for active slots), decode attention per layer.
        Returns (num_slots, vocab) fp32 logits."""
        cfg = self.cfg
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=self.device)
        nval = torch.as_tensor(np.asarray(active_mask), device=self.device).to(torch.int32)
        positions = self.caches[0].lengths.clone()  # pre-append lengths
        offsets = positions.to(torch.int64)

        def attend(idx, q, k_new, v_new):
            cache = kvc.append(
                self.caches[idx], self._slot_ids, k_new[:, :, None, :].float(),
                v_new[:, :, None, :].float(), offsets, nval,
            )
            return decode_attention(
                q.to(torch.bfloat16).contiguous(), cache.k, cache.v,
                cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
            )

        return llama.forward_decode(params, tokens, positions, cfg, attend)

    # -- bookkeeping -------------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        return self.caches[0].lengths.cpu().numpy()

    def release(self, slot: int) -> None:
        """Return the slot's rows (lengths 0) in every layer."""
        ids = self._tensor([slot])
        for cache in self.caches:
            kvc.free_slots(cache, ids)
