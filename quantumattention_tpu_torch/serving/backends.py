"""Cache backend of the continuous-batching engine (counterpart of
quantumattention_tpu/serving/backends.py).

``SlotsBackend`` owns one ``kv_cache.KVCache`` per layer, contiguous rows
(num_slots, Hkv, max_len, D) per slot, and everything that reads or writes
them: the prefill forward with its cache writes, the decode step over all
slots, decode bursts, and slot release.

A decode step takes one of two routes, as ``_decode_step_impl`` does in
JAX (backends.py:364-376): the fused route when
``ops/megastep.megastep_supported`` holds (each layer one call of kernel
K9 after RoPE, the int8 quantization of k and v and the cache write), else
the unfused one (``llama.forward_decode``: lean decode with the decode
kernel K4 and, on a fused quantized tree, the tail kernel K8).

A burst runs n decode steps with sampling, EOS detection and per-slot
budgets on the device, and returns one packed (2 or 3, n, B) trace with one
host fetch (``_burst_impl``, backends.py:601-674).  On a CUDA device the
step is captured once as a CUDA graph per (params, sampling, logprobs,
route) and replayed n times; the first burst runs its first step eagerly
(the warm-up: kernel build, library handles, first allocations) and
captures the next.  A failed capture raises.  On the CPU the same step
function runs n times in a Python loop.  The cache is appended to in place
every step, so the JAX burst's side buffers and once-per-burst flush
(``_burst_impl_mega``, a TPU workaround) are not ported.

Not ported: the paged backend (ROADMAP queue 1, item 17), chunked prefill,
speculative verification and tensor-parallel meshes (items 15 and 19).
Buffer donation is not ported either: it exists for JAX's immutable arrays,
and the PyTorch cache is updated in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models import llama, quantized
from ..ops import megastep, qmlp, qmm, quant
from ..ops.decode import decode_attention
from . import kv_cache as kvc
from .sampling import SamplingParams, sample, sample_with_logprob


def _launch_counters():
    """(wrapper, attribute) of every kernel launch counter a decode step
    can move.  A graph replay launches what its capture recorded, so each
    replay adds the capture's counts to these."""
    return [
        (decode_attention, "launches"),
        (qmm.quantized_matmul, "launches"),
        (qmm.quantized_matmul, "splitk_launches"),
        (qmm.quantized_matmul4, "launches"),
        (qmlp.fused_layer_tail, "launches"),
        (megastep.fused_decode_layer, "launches"),
    ]


class _Burst:
    """Device state of the bursts of one key: the step's inputs (tokens,
    active, remaining, EOS ids), a step counter, the (rows, capacity, B)
    trace, and on a CUDA device the step captured as a graph."""

    def __init__(self, backend: "SlotsBackend", params, sp: SamplingParams, want_lp: bool,
                 generator: Optional[torch.Generator], capacity: int) -> None:
        dev, b = backend.device, backend.num_slots
        self.backend, self.params, self.sp, self.want_lp = backend, params, sp, want_lp
        self.generator = generator if sp.temperature > 0.0 else None
        self.capacity = capacity
        self.tokens = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.eos = torch.full((b,), -1, dtype=torch.int64, device=dev)
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        # Token ids round-trip exactly through float32 (vocab < 2^24).
        dtype = torch.float32 if want_lp else torch.int32
        self.trace = torch.zeros((3 if want_lp else 2, capacity, b), dtype=dtype, device=dev)
        self.graph = None
        self.graph_launches = None

    def load(self, tokens, active, remaining, eos_ids) -> None:
        for buf, host in ((self.tokens, tokens), (self.active, active),
                          (self.remaining, remaining), (self.eos, eos_ids)):
            buf.copy_(torch.as_tensor(np.asarray(host)).to(buf.dtype))
        self.t.zero_()

    def step(self) -> None:
        """One decode step and its trace row, on the device only."""
        logits = self.backend._step(self.params, self.tokens, self.active)
        if self.want_lp:
            nxt, lp = sample_with_logprob(logits, self.sp, self.generator)
        else:
            nxt, lp = sample(logits, self.sp, self.generator), None
        emitted = self.active.clone()
        nxt = torch.where(self.active, nxt.to(torch.int64), self.tokens)
        self.remaining.sub_(self.active.to(torch.int32))
        hit_eos = (nxt == self.eos) & (self.eos >= 0)
        self.active.logical_and_(~hit_eos & (self.remaining > 0))
        self.tokens.copy_(nxt)
        dt = self.trace.dtype
        rows = [nxt.to(dt), emitted.to(dt)] + ([lp.to(dt)] if self.want_lp else [])
        self.trace.index_copy_(1, self.t, torch.stack(rows)[:, None, :])
        self.t.add_(1)

    def capture(self) -> None:
        """Record one step as a CUDA graph.  The capture launches nothing,
        so the counters it moved are restored and credited per replay."""
        counters = _launch_counters()
        before = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            self.step()
        self.graph_launches = [getattr(fn, attr) - b for (fn, attr), b in zip(counters, before)]
        for (fn, attr), b in zip(counters, before):
            setattr(fn, attr, b)
        self.graph = graph
        self.backend.stats["graph_captures"] += 1

    def replay(self) -> None:
        self.graph.replay()
        for (fn, attr), n in zip(_launch_counters(), self.graph_launches):
            setattr(fn, attr, getattr(fn, attr) + n)
        self.backend.stats["graph_replays"] += 1


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
        self._bursts = {}
        self.stats = {"bursts": 0, "host_fetches": 0, "graph_captures": 0, "graph_replays": 0}

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

    def route(self, params) -> str:
        """"mega" when the fused decode layer (K9) takes the step, else
        "unfused"."""
        if megastep.megastep_supported(self.cfg, params, self.caches[0], self.num_slots):
            return "mega"
        return "unfused"

    def _step(self, params, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One decode step over all slots from device tensors (tokens (B,)
        int64, active (B,) bool), with no host synchronisation: append each
        slot's token K/V (lengths bumped only for active slots), attend,
        return (B, vocab) fp32 logits."""
        if self.route(params) == "mega":
            return self._step_mega(params, tokens, active)
        positions = self.caches[0].lengths.clone()  # pre-append lengths
        offsets = positions.to(torch.int64)
        nval = active.to(torch.int32)

        def attend(idx, q, k_new, v_new):
            cache = kvc.append(
                self.caches[idx], self._slot_ids, k_new[:, :, None, :].float(),
                v_new[:, :, None, :].float(), offsets, nval,
            )
            return decode_attention(
                q.to(torch.bfloat16).contiguous(), cache.k, cache.v,
                cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
            )

        return llama.forward_decode(params, tokens, positions, self.cfg, attend)

    def _step_mega(self, params, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """The fused route (``_decode_step_mega_impl``, backends.py:292-362):
        embedding and layer 0's RMSNorm + QKV (K5/K6); per layer the packed
        RoPE, int8 quantization of k and v, the cache write at the
        pre-append positions, then K9 over the post-append cache, which
        also emits the next layer's QKV; final norm and LM head."""
        cfg = self.cfg
        positions = self.caches[0].lengths.clone()  # pre-append lengths
        nval = active.to(torch.int32)
        ctx = megastep.build_decode_ctx(positions, active, self.max_len)
        cos, sin = llama.decode_rope_tables(positions, cfg)
        x = quantized.embed_lookup(params["embed"], tokens, cfg.dtype)
        layers = params["layers"]
        h0 = llama.rms_norm(x, layers[0]["attn_norm"], cfg.rms_norm_eps)
        qkv = quantized.matmul(h0, layers[0]["w_qkv"])
        for idx, layer in enumerate(layers):
            q, k, v = llama.decode_qkv(cfg, qkv, cos, sin)
            kq, ks = quant.dynamically_quantize_int8(k.float(), reduction_dim=-1)
            vq, vs = quant.dynamically_quantize_int8(v.float(), reduction_dim=-1)
            cache = kvc.append_quantized_token(self.caches[idx], kq, ks, vq, vs, positions, nval)
            nxt = layers[idx + 1] if idx + 1 < len(layers) else None
            x, qkv = megastep.fused_decode_layer(
                x, q.contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale, ctx, layer,
                next_attn_norm=None if nxt is None else nxt["attn_norm"],
                next_w_qkv=None if nxt is None else nxt["w_qkv"],
                eps=cfg.rms_norm_eps,
            )
        return llama.decode_head(params, x, cfg)

    @torch.no_grad()
    def decode(self, params, tokens, active_mask, active_slots=None) -> torch.Tensor:
        """One decode step over all slots (host inputs).  Returns
        (num_slots, vocab) fp32 logits."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=self.device)
        active = torch.as_tensor(np.asarray(active_mask), device=self.device).to(torch.bool)
        return self._step(params, tokens, active)

    @torch.no_grad()
    def burst(
        self, params, tokens, active, remaining, eos_ids, generator,
        n_steps: int, sp: SamplingParams, want_lp: bool,
    ) -> np.ndarray:
        """``n_steps`` decode steps on the device; returns the packed trace
        (tokens, emitted mask[, logprobs]) of shape (2 or 3, n_steps, B),
        fetched once.  A slot's next token replaces its current one only
        while it is active; it stops on its EOS id or its budget."""
        key = (id(params), sp, want_lp, self.route(params))
        state = self._bursts.get(key)
        if state is None or state.capacity < n_steps:
            state = _Burst(self, params, sp, want_lp, generator, n_steps)
            self._bursts[key] = state
        state.load(tokens, active, remaining, eos_ids)
        n = n_steps
        if self.device.type == "cuda":
            if state.graph is None:
                state.step()  # warm-up, and this burst's first step
                n -= 1
                state.capture()
            for _ in range(n):
                state.replay()
        else:
            for _ in range(n):
                state.step()
        self.stats["bursts"] += 1
        self.stats["host_fetches"] += 1
        return state.trace[:, :n_steps].cpu().numpy()

    # -- bookkeeping -------------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        return self.caches[0].lengths.cpu().numpy()

    def release(self, slot: int) -> None:
        """Return the slot's rows (lengths 0) in every layer."""
        ids = self._tensor([slot])
        for cache in self.caches:
            kvc.free_slots(cache, ids)
