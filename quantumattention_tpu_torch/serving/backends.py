"""Cache backends of the continuous-batching engine (counterpart of
quantumattention_tpu/serving/backends.py).

``SlotsBackend`` owns one ``kv_cache.KVCache`` per layer, contiguous rows
(num_slots, Hkv, max_len, D) per slot, and everything that reads or writes
them: the prefill forward with its cache writes, chunked prefill, the decode
step over all slots, decode bursts, and slot release.  ``PagedBackend``
(backends.py:754-1623) owns a page pool per layer
(``serving/paged_cache.LayerPages``) and the host ``PageAllocator`` (free
list, page tables, the refcounted prefix cache); its decode step writes
each slot's token into the page its table names and attends through kernel
K10 (``ops/paged.paged_decode_attention``).

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

The single decode step (``decode``, which the engine runs after each
prefill forward while requests wait or prefill, and a draft runs in its
speculative rounds) is replayed from a graph the same way: its host tokens
and active mask are copied into static device buffers, and the step of
each (params, route, flags) is captured over them; a key's first call runs
eagerly (the warm-up), its second captures and replays, every later call
replays.  The logits come back as a copy of the graph's output, so no
later call overwrites them.  Sampling stays with the caller.  Both graphs
of a backend allocate from one memory pool (``_Graph``).  On the CPU and
under a mesh both run eagerly, as bursts do.

A graph replays the kernels its capture chose.  The ``config`` flags
(``config.snapshot``) are part of every graph's key, burst's and step's,
so a changed flag gets a graph of its own; a module function swapped after
a capture (a test's plain version) is not seen, and needs the uncaptured
step (``backend._step``, or ``_graphs`` false).

``stats`` counts ``bursts``, the burst graph's ``graph_captures`` and
``graph_replays`` (one a burst step), and the single step's
``step_captures`` and ``step_replays`` (one a ``decode`` call).

A prefill chunk (``prefill_chunk``, both backends) attends over the
slot's cached prefix, dequantized to bf16, and the chunk itself through K1
with ``q_offset`` = the chunk's start (``_chunk_prefix_attend``,
backends.py:66-108), then writes the chunk.  Under a sliding window
(``window_of(cfg)``, passed to every attention call: prefill, chunks, K4,
K9, K10 and both verify passes) only the prefix rows inside the chunk's
window are gathered, and K1 takes their start as ``kv_offset``.

Speculative decoding (``verify``, ``rollback``, ``can_speculate`` on both
backends, backends.py:173, :678-736, :882-894, :1572-1611): ``verify``
appends T candidate tokens to every active slot and scores all T in one
``llama.forward_chunk``, whose attention is K4's or K10's multi-query mode
(on every route: a fused int8 tree's layers run K5/K6 and K8 at B * T rows
there, K9 stays a T = 1 kernel); ``rollback`` sets the slots' lengths back
to what was accepted (rows past a length are garbage by contract and the
next write overwrites them).

Tensor-parallel serving (``SlotsBackend(mesh=, tp_axis=)``,
``serving/tp.py``): every rank runs the same schedule over its Megatron
slices of the tree and caches of its own KV heads; decode attention is
``tp.decode_attention_tp`` (K4 on the local heads), a prefill chunk
``tp.chunk_attention_tp`` (K1 on them).  A burst under a mesh runs its
steps in a loop: a gloo collective cannot be captured in a CUDA graph.
Rank 0's sampled tokens are broadcast each step, so the ranks never
drift apart on a near-tie.

Not ported: the paged
burst's side buffers
(``_burst_impl_side``, ``_flush_side_pages``: a TPU workaround; the port
writes pages in place every step).  Buffer donation is not ported either:
it exists for JAX's immutable arrays, and the PyTorch caches are updated in
place.
"""

from __future__ import annotations

import functools
import gc
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config
from ..models import llama, quantized
from ..models.llama import window_of
from ..ops import megastep, qmlp, qmm, quant
from ..ops.decode import decode_attention
from ..ops.flash import flash_attention
from ..ops.paged import paged_decode_attention
from ..parallel import mesh as mesh_lib
from ..utils import checks
from ..utils.profiling import span
from . import kv_cache as kvc
from . import tp as tp_lib
from . import paged_cache as pgc
from .sampling import SamplingParams, sample, sample_with_logprob


def _launch_counters():
    """(wrapper, attribute) of every kernel launch counter a decode step
    can move.  A graph replay launches what its capture recorded, so each
    replay adds the capture's counts to these."""
    return [
        (decode_attention, "launches"),
        (decode_attention, "window_launches"),
        (qmm.quantized_matmul, "launches"),
        (qmm.quantized_matmul, "splitk_launches"),
        (qmm.quantized_matmul4, "launches"),
        (qmlp.fused_layer_tail, "launches"),
        (megastep.fused_decode_layer, "launches"),
        (megastep.fused_decode_layer, "window_launches"),
        (paged_decode_attention, "launches"),
        (paged_decode_attention, "window_launches"),
    ]


def _as_tensor(values, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Host values (an array or a list) or a tensor as a ``dtype`` tensor on
    ``device`` (None: a tensor's own device, host values' host): the one
    conversion of the backends' step inputs."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)


def prefix_start(off: int, window) -> int:
    """The first cached row a chunk starting at ``off`` can see: 0, or the
    left window edge of its first query."""
    return 0 if window is None else max(0, off - window[0])


def chunk_per_block(cfg) -> bool:
    """Whether chunked prefill quantizes Q and K per block: a config whose
    fp8 attention is "per-block", or "auto", whose untuned default that is
    (a chunk's offsets lie outside the entry points the "auto" sweep
    times).  JAX's chunks always run bf16 K1, as the port's do for the
    other scaling methods."""
    return cfg.attention_impl == "fp8" and cfg.scaling_method in ("per-block", "auto")


def _chunk_prefix_attend(q, k_new, v_new, prefix, off: int, window=None,
                         per_block: bool = False) -> torch.Tensor:
    """Attention of a prefill chunk over the slot's cached rows before
    ``off`` and itself (``_chunk_prefix_attend``, backends.py:66-108): the
    prefix rows from ``start = prefix_start(off, window)`` on (``prefix(start)``
    -> (k, v), (1, Hkv, off - start, D) bf16, dequantized per element) are
    concatenated with the chunk's K/V, then K1 runs causal with ``q_offset =
    off``, ``kv_offset = start`` and the window.  ``per_block``: Q and the
    gathered K quantized per block first (``fused_block_quant``; the blocks
    count from the gathered K's row 0)."""
    start = prefix_start(off, window)
    if off > start:
        k_pre, v_pre = prefix(start)
        k_new = torch.cat([k_pre, k_new.to(torch.bfloat16)], dim=2)
        v_new = torch.cat([v_pre, v_new.to(torch.bfloat16)], dim=2)
    else:
        start = off
    return flash_attention(q, k_new, v_new, is_causal=True, q_offset=off, kv_offset=start,
                           window=window, fused_block_quant=per_block)


def slot_prefix(cache: kvc.KVCache, slot: int, off: int, kv_int4: bool = False):
    """``prefix(start)`` of :func:`_chunk_prefix_attend` over a slot cache:
    the slot's rows [start, off) of K and V, dequantized to bf16."""

    def prefix(start):
        return tuple(
            _dequantize_rows(vals[slot : slot + 1, :, start:off],
                             None if sc is None else sc[slot : slot + 1, :, start:off],
                             -1 if kv_int4 else None)
            for vals, sc in ((cache.k, cache.k_scale), (cache.v, cache.v_scale))
        )

    return prefix


def _dequantize_rows(values: torch.Tensor, scales, int4_axis: Optional[int] = None) -> torch.Tensor:
    """Cached rows (..., D) and their token scales (...) -> bf16.  A packed
    int4 container is unpacked first along ``int4_axis`` (backends.py:86-88,
    1015-1019): the head dim of a slot cache (-1), a page's token axis (2)."""
    if int4_axis is not None:
        values = quant.unpack_int4(values, axis=int4_axis)
    x = values.float()
    if scales is not None:
        x = x * scales.float()[..., None]
    return x.to(torch.bfloat16)


def _graphs(backend) -> bool:
    """Whether the backend replays its steps from CUDA graphs: on a CUDA
    device without a mesh (a gloo collective cannot be captured)."""
    return backend.device.type == "cuda" and backend.tp is None


def _load(buf: torch.Tensor, values) -> None:
    """Host values (or a device tensor) into a static device buffer, in place."""
    buf.copy_(_as_tensor(values, buf.dtype))


class _Graph:
    """One function captured as a CUDA graph and replayed, counted in the
    backend's ``stats[f"{name}_captures"]`` and ``stats[f"{name}_replays"]``.

    Every graph of a backend allocates from one memory pool.  That is safe
    because the graphs replay one at a time on one stream and none keeps an
    output in the pool across another's replay: a burst writes only buffers
    made before its capture, and the single step's logits are copied out
    right after each replay."""

    def __init__(self, backend, name: str, generator: Optional[torch.Generator] = None) -> None:
        self.backend, self.name, self.generator = backend, name, generator
        self.graph = None
        self.launches = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self, fn):
        """Record ``fn()``; returns what it returned (the graph's static
        outputs).  The capture launches nothing, so the kernel launch
        counters it moved are restored and credited per replay."""
        with span("backend.capture"):
            counters = _launch_counters()
            before = [getattr(f, attr) for f, attr in counters]
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            if self.backend._graph_pool is None:
                self.backend._graph_pool = torch.cuda.graph_pool_handle()
            # No cyclic collection inside the capture: a dead backend's graphs
            # (a backend and its graphs form a cycle) destroyed there would
            # invalidate it.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.backend._graph_pool):
                    out = fn()
            finally:
                if collecting:
                    gc.enable()
            self.launches = [getattr(f, attr) - b for (f, attr), b in zip(counters, before)]
            for (f, attr), b in zip(counters, before):
                setattr(f, attr, b)
            self.graph = graph
            self.backend.stats[self.name + "_captures"] += 1
        return out

    def replay(self) -> None:
        self.graph.replay()
        for (f, attr), n in zip(_launch_counters(), self.launches):
            setattr(f, attr, getattr(f, attr) + n)
        self.backend.stats[self.name + "_replays"] += 1


class _Burst:
    """Device state of the bursts of one key: the step's inputs (tokens,
    active, remaining, EOS ids), a step counter, the (rows, capacity, B)
    trace, and the step's graph."""

    def __init__(self, backend, params, sp: SamplingParams, want_lp: bool,
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
        self.graph = _Graph(backend, "graph", self.generator)

    def load(self, tokens, active, remaining, eos_ids) -> None:
        for buf, host in ((self.tokens, tokens), (self.active, active),
                          (self.remaining, remaining), (self.eos, eos_ids)):
            _load(buf, host)
        self.t.zero_()

    def step(self) -> None:
        """One decode step and its trace row, on the device only."""
        logits = self.backend._step(self.params, self.tokens, self.active)
        if self.want_lp:
            nxt, lp = sample_with_logprob(logits, self.sp, self.generator)
        else:
            nxt, lp = sample(logits, self.sp, self.generator), None
        tp = self.backend.tp
        if tp is not None:
            nxt = tp.broadcast(nxt)
            lp = None if lp is None else tp.broadcast(lp)
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


def _run_burst(backend, key, params, tokens, active, remaining, eos_ids, generator,
               n_steps: int, sp: SamplingParams, want_lp: bool) -> np.ndarray:
    """``n_steps`` of ``backend._step`` on the device with sampling, EOS and
    budgets; returns the packed (2 or 3, n_steps, B) trace, fetched once.
    On a CUDA device the step is captured once per ``key`` as a graph (the
    first burst's first step runs eagerly: the warm-up) and replayed; on
    the CPU, and under a tensor-parallel mesh, it runs in a loop."""
    state = backend._bursts.get(key)
    if state is None or state.capacity < n_steps:
        state = _Burst(backend, params, sp, want_lp, generator, n_steps)
        backend._bursts[key] = state
    state.load(tokens, active, remaining, eos_ids)
    n = n_steps
    if _graphs(backend):
        if not state.graph.captured:
            state.step()  # warm-up, and this burst's first step
            n -= 1
            state.graph.capture(state.step)
        with span("backend.replay"):
            for _ in range(n):
                state.graph.replay()
    else:
        for _ in range(n):
            state.step()
    backend.stats["bursts"] += 1
    with span("backend.fetch"):
        return state.trace[:, :n_steps].cpu().numpy()


class _Step:
    """Device state of the single decode step of one key: the params tree
    (held, so that the key's id names it while the graph reads it), static
    token and active buffers, the step's graph and its (B, vocab) logits,
    the graph's output."""

    def __init__(self, backend, params) -> None:
        dev, b = backend.device, backend.num_slots
        self.params = params
        self.tokens = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.graph = _Graph(backend, "step")
        self.logits = None


def _run_step(backend, params, tokens, active_mask) -> torch.Tensor:
    """One ``backend._step`` over all slots from host inputs (``tokens``
    may be a device tensor); returns (B, vocab) fp32 logits that no later
    call overwrites.  On a CUDA device without a mesh the step is keyed by
    (params, route, the config flags), as bursts are without their
    sampling: a key's first call runs eagerly over its static buffers (the
    warm-up), its second captures the step as a graph over them and
    replays it, and every later call replays.  On the CPU and under a mesh
    the step runs eagerly."""
    dev = backend.device
    if not _graphs(backend):
        return backend._step(params, _as_tensor(tokens, torch.int64, dev),
                             _as_tensor(active_mask, torch.bool, dev))
    key = (id(params), backend.route(params), config.snapshot())
    state = backend._steps.get(key)
    first = state is None
    if first:
        state = backend._steps[key] = _Step(backend, params)
    _load(state.tokens, tokens)
    _load(state.active, active_mask)

    def step():
        return backend._step(params, state.tokens, state.active)

    if first:
        return step()  # the warm-up
    if not state.graph.captured:
        state.logits = state.graph.capture(step)
    state.graph.replay()
    return state.logits.clone()


class SlotsBackend:
    """Contiguous slot cache: one (Hkv, max_len, D) row region per slot."""

    name = "slots"

    def __init__(
        self, cfg: llama.LlamaConfig, *, num_slots: int, max_len: int,
        cache_dtype=torch.int8, kv_int4: bool = False, device=None, mesh=None,
        tp_axis: str = "tp",
    ) -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_int4 = kv_int4
        self.device = checks.default_device(device)
        #: Tensor-parallel serving: the mesh's ``tp`` axis; the caches hold
        #: this rank's KV heads.
        self.tp = None if mesh is None else mesh_lib.axis(mesh, tp_axis)
        n = 1 if self.tp is None else self.tp.size
        self.caches = [
            kvc.init_cache(
                num_slots, cfg.num_kv_heads // n, max_len, cfg.head_dim,
                cache_dtype, int4=kv_int4, device=self.device,
            )
            for _ in range(cfg.num_layers)
        ]
        self._slot_ids = torch.arange(num_slots, dtype=torch.int64, device=self.device)
        self._bursts = {}
        self._steps = {}
        self._graph_pool = None
        self.stats = {"bursts": 0, "graph_captures": 0, "graph_replays": 0,
                      "step_captures": 0, "step_replays": 0}

    # -- admission (slot rows are pre-sized to max_len) -----------------------

    def check_submit(self, reservation: int) -> None:
        pass

    def try_admit(self, req, slot: int, reservation: int) -> Optional[int]:
        return 0  # storage pre-exists; no reservation, no prefix reuse

    def register_prefix(self, req) -> None:
        pass

    def can_speculate(self, active_slots, t_width: int) -> bool:
        return True  # slot rows are pre-sized to max_len

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

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, req, off: int, tc: int) -> torch.Tensor:
        """One prefill chunk of ``req`` (``_prefill_chunk_impl``,
        backends.py:236-290): tokens (1, T) of which the first ``tc`` are
        real, at positions off..off+T-1; attends over the slot's first
        ``off`` rows and the chunk, then writes the chunk's T rows at
        ``off`` (rows past ``tc`` hold garbage that the length masks and the
        next chunk overwrites; ``max_len % prefill_chunk == 0`` keeps them in
        the cache).  Returns (1, T, vocab) fp32 logits."""
        slot = req.slot
        positions = off + torch.arange(tokens.shape[1], dtype=torch.int32, device=self.device)
        recorded = {}
        window, per_block = window_of(self.cfg), chunk_per_block(self.cfg)

        def attend(idx, q, k_new, v_new):
            recorded[idx] = (k_new, v_new)
            c = self.caches[idx]
            if self.tp is not None:
                return tp_lib.chunk_attention_tp(
                    q, k_new, v_new, c, slot, off, mesh=self.tp.mesh, axis=self.tp.name,
                    window=window, kv_int4=self.kv_int4, per_block=per_block,
                )
            return _chunk_prefix_attend(q, k_new, v_new, slot_prefix(c, slot, off, self.kv_int4),
                                        off, window, per_block)

        logits = llama.forward_chunk(params, tokens, positions, self.cfg, attend, tp=self.tp)
        ids, offs, nval = self._tensor([slot]), self._tensor([off]), self._tensor([tc])
        for idx, cache in enumerate(self.caches):
            k, v = recorded[idx]
            kvc.append(cache, ids, k.float(), v.float(), offs, nval)
        return logits

    # -- decode ----------------------------------------------------------------

    def route(self, params) -> str:
        """"mega" when the fused decode layer (K9) takes the step, else
        "unfused"."""
        if megastep.megastep_supported(self.cfg, params, self.caches[0], self.num_slots,
                                       mesh=None if self.tp is None else self.tp.mesh):
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

        attention = decode_attention
        if self.tp is not None:
            attention = functools.partial(tp_lib.decode_attention_tp, mesh=self.tp.mesh,
                                          axis=self.tp.name)

        def attend(idx, q, k_new, v_new):
            cache = kvc.append(
                self.caches[idx], self._slot_ids, k_new[:, :, None, :].float(),
                v_new[:, :, None, :].float(), offsets, nval,
            )
            return attention(
                q.to(torch.bfloat16).contiguous(), cache.k, cache.v,
                cache.lengths, k_scale=cache.k_scale, v_scale=cache.v_scale,
                window=window_of(self.cfg),
            )

        return llama.forward_decode(params, tokens, positions, self.cfg, attend, tp=self.tp)

    def _step_mega(self, params, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """The fused route (``_decode_step_mega_impl``, backends.py:292-362):
        embedding and layer 0's RMSNorm + QKV (K5/K6); per layer the packed
        RoPE, int8 quantization of k and v, the cache write at the
        pre-append positions, then K9 over the post-append cache, which
        also emits the next layer's QKV; final norm and LM head."""
        cfg = self.cfg
        positions = self.caches[0].lengths.clone()  # pre-append lengths
        nval = active.to(torch.int32)
        window = window_of(cfg)
        ctx = megastep.build_decode_ctx(positions, active, self.max_len,
                                        window_left=None if window is None else window[0])
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
        """One decode step over all slots (host inputs; ``tokens`` may be a
        device tensor, as a draft's proposals are), replayed from a graph on
        the card (``_run_step``).  Returns (num_slots, vocab) fp32 logits."""
        return _run_step(self, params, tokens, active_mask)

    @torch.no_grad()
    def burst(
        self, params, tokens, active, remaining, eos_ids, generator,
        n_steps: int, sp: SamplingParams, want_lp: bool,
    ) -> np.ndarray:
        """``n_steps`` decode steps on the device; returns the packed trace
        (tokens, emitted mask[, logprobs]) of shape (2 or 3, n_steps, B),
        fetched once.  A slot's next token replaces its current one only
        while it is active; it stops on its EOS id or its budget."""
        key = (id(params), sp, want_lp, self.route(params), config.snapshot())
        return _run_burst(self, key, params, tokens, active, remaining, eos_ids, generator,
                          n_steps, sp, want_lp)

    # -- speculative decoding --------------------------------------------------

    @torch.no_grad()
    def verify(self, params, cand, positions, active_mask) -> torch.Tensor:
        """Append the (num_slots, T) candidate tokens ``cand`` (a device
        tensor) to every active slot at its ``positions`` (host, the
        pre-append lengths) and score all T positions in one forward
        (``_verify_impl``, backends.py:678-716): attention is K4's
        multi-query mode over the post-append lengths.  Inactive slots are
        neither written nor grown.  Returns (num_slots, T, vocab) fp32
        logits."""
        if self.tp is not None:
            raise ValueError(
                "speculative decoding is a single-chip path (the "
                "multi-query verification kernel is not head-sharded)"
            )
        tokens = _as_tensor(cand, torch.int64, self.device)
        t_width = tokens.shape[1]
        pos = torch.as_tensor(np.asarray(positions), dtype=torch.int32, device=self.device)
        ids = self._tensor(np.flatnonzero(np.asarray(active_mask, bool)))
        pos2d = pos[:, None] + torch.arange(t_width, dtype=torch.int32, device=self.device)

        def attend(idx, q, k_new, v_new):
            cache = kvc.append(self.caches[idx], ids, k_new[ids].float(), v_new[ids].float(), pos[ids])
            return decode_attention(
                q.to(torch.bfloat16).contiguous(), cache.k, cache.v, cache.lengths,
                k_scale=cache.k_scale, v_scale=cache.v_scale, window=window_of(self.cfg),
            )

        return llama.forward_chunk(params, tokens, pos2d, self.cfg, attend)

    def rollback(self, rollback_mask, new_lengths) -> None:
        """Set the masked slots' lengths to ``new_lengths`` in every layer."""
        rb = torch.as_tensor(np.asarray(rollback_mask, bool), device=self.device)
        nl = torch.as_tensor(np.asarray(new_lengths), dtype=torch.int32, device=self.device)
        for cache in self.caches:
            cache.lengths.copy_(torch.where(rb, nl, cache.lengths))

    # -- bookkeeping -------------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        """A host copy of the slots' lengths (on the CPU, ``.numpy()`` of the
        tensor would share its memory, which the next append moves)."""
        return self.caches[0].lengths.cpu().numpy().copy()

    def release(self, slot: int) -> None:
        """Return the slot's rows (lengths 0) in every layer."""
        ids = self._tensor([slot])
        for cache in self.caches:
            kvc.free_slots(cache, ids)


class PagedBackend:
    """vLLM-style paged cache: a page pool per layer and per-slot page
    tables (backends.py:754-1623).

    Admission makes a FULL reservation (the padded prompt and every new
    token) before a request leaves the waiting queue, so no prefill chunk,
    decode step or burst can run out of pages, and a burst runs over fixed
    tables.  Page ``num_pages`` is one page past the allocator's pool, the
    trash page: inactive slots' decode lanes write there, because their
    table rows may name pages another sequence owns now (backends.py:797-802).

    The device holds the page tensors and two persistent buffers, the page
    tables and the per-slot positions, which a per-step ``decode`` or a
    ``burst`` refreshes in place from the host allocator before it runs; a
    step reads and advances them on the device alone, so a burst's step is
    captured once as a CUDA graph, as on the slots backend.
    """

    name = "paged"
    tp = None  # tensor-parallel serving takes the slots backend only

    def __init__(
        self, cfg: llama.LlamaConfig, *, num_slots: int, max_len: int,
        cache_dtype=torch.int8, kv_int4: bool = False, page_size: int = 128,
        num_pages: Optional[int] = None, prefix_cache: bool = False, device=None,
    ) -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self.kv_int4 = kv_int4
        self.device = checks.default_device(device)
        pages_per_seq = -(-max_len // page_size)
        if num_pages is None:
            # Every slot at max_len: the slots backend's capacity.
            num_pages = num_slots * pages_per_seq + 1
        self._trash_page = num_pages
        self.pages = [
            pgc.init_layer_pages(
                cfg.num_kv_heads, num_pages + 1, page_size, cfg.head_dim, cache_dtype,
                int4=kv_int4, device=self.device,
            )
            for _ in range(cfg.num_layers)
        ]
        self.alloc = pgc.PageAllocator(num_pages, num_slots, pages_per_seq)
        # The largest pages-per-block that divides the table width (JAX's
        # choice; K10 validates it and tiles the pages its own way).
        self._pages_per_block = next(n for n in (4, 2, 1) if pages_per_seq % n == 0)
        self._tables = torch.zeros((num_slots, pages_per_seq), dtype=torch.int32, device=self.device)
        self._positions = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self._bursts = {}
        self._steps = {}
        self._graph_pool = None
        self.stats = {"bursts": 0, "graph_captures": 0, "graph_replays": 0,
                      "step_captures": 0, "step_replays": 0}

    # -- admission -------------------------------------------------------------

    def check_submit(self, reservation: int) -> None:
        """Refuse a request that could NEVER be admitted: its full
        reservation exceeds the whole pool."""
        need = self.alloc.pages_for(reservation, self.page_size)
        if need > self.alloc.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.alloc.num_pages}; raise num_pages or shrink the request"
            )

    def _prompt_hashes(self, req) -> List[bytes]:
        return pgc.hash_pages(req.prompt, self.page_size)

    def try_admit(self, req, slot: int, reservation: int) -> Optional[int]:
        """Reserve the request's full footprint; None is FIFO backpressure.
        With the prefix cache on, cached prompt pages are adopted (shared,
        refcounted) and the matched token count returned: prefill resumes
        at the first page not cached."""
        matched: List[int] = []
        if self.prefix_cache:
            # At least one prompt token always prefills: the first sampled
            # token needs fresh last-position logits.
            usable = (len(req.prompt) - 1) // self.page_size
            matched = self.alloc.match_prefix(self._prompt_hashes(req)[:usable])
        need = self.alloc.pages_for(reservation, self.page_size) - len(matched)
        # Matched idle pages leave the evictable pool on adoption.
        avail = self.alloc.free_pages + max(0, self.alloc.evictable_pages - len(matched))
        if need > avail:
            return None
        if matched:
            self.alloc.adopt(slot, matched)
        self.alloc.allocate(slot, reservation, self.page_size)
        n_matched = len(matched) * self.page_size
        if matched:
            self.alloc.lengths[slot] = n_matched
        return n_matched

    def register_prefix(self, req) -> None:
        """Publish a fully prefilled prompt's whole pages (a page holding
        rows past the prompt is never whole, so never published)."""
        hashes = self._prompt_hashes(req)
        if hashes:
            self.alloc.register(req.slot, hashes)

    def can_speculate(self, active_slots, t_width: int) -> bool:
        """Verification appends ``t_width`` rows to every active slot before
        acceptance, possibly past the admission reservation when a request's
        budget is nearly spent: run a round only when the pool can cover
        every slot's growth (backends.py:882-894); else the engine decodes
        a token at a time."""
        need = 0
        for s in active_slots:
            want = self.alloc.pages_for(int(self.alloc.lengths[s]) + t_width, self.page_size)
            need += max(0, want - int(self.alloc.allocated[s]))
        return need <= self.alloc.free_pages + self.alloc.evictable_pages

    # -- prefill ---------------------------------------------------------------

    def _ids(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64).reshape(-1), device=self.device)

    def write_prefill_batch(
        self, kv, slots: Sequence[int], n_valid: Sequence[int], padded: int
    ) -> None:
        """Every request's and every layer's prefill rows into the slots'
        own pages, one indexed assignment per page tensor per layer
        (``_batched_page_write``, backends.py:898-948): requests own
        disjoint pages, so the write is exact.  Token-packed int4 pages are
        packed whole here (split halves along each page's tokens)."""
        ps = self.page_size
        n_pg = -(-padded // ps)
        pids = self._ids(self.alloc.tables[list(slots), :n_pg])
        kreq = len(slots)
        for lp, (k, v) in zip(self.pages, kv):
            for dst, dsc, x in ((lp.k, lp.k_scale, k), (lp.v, lp.v_scale, v)):
                hkv, d = x.shape[1], x.shape[3]
                xq, xs = pgc.quantize_page_tokens(x.float(), dst.dtype, self.kv_int4)
                xq = xq.reshape(kreq, hkv, n_pg, ps, d)
                if self.kv_int4:
                    xq = quant.pack_int4(xq, axis=3)
                dst[:, pids] = xq.transpose(0, 1).reshape(hkv, kreq * n_pg, dst.shape[2], d)
                if xs is not None:
                    dsc[:, pids] = (xs.reshape(kreq, hkv, n_pg, ps).transpose(0, 1)
                                    .reshape(hkv, kreq * n_pg, ps))
        for slot, n in zip(slots, n_valid):
            self.alloc.lengths[slot] = n

    def prefill_and_write(
        self, prefill_fn, params, tokens, last_pos,
        slots: Sequence[int], n_valid: Sequence[int], padded: int,
    ) -> torch.Tensor:
        """Whole-prompt prefill forward, then the batched page write.
        Returns the last-position logits (B, vocab)."""
        last = torch.as_tensor(list(last_pos), dtype=torch.int64, device=self.device)
        logits, kv = prefill_fn(params, tokens, last_pos=last)
        self.write_prefill_batch(kv, slots, n_valid, padded)
        return logits

    @torch.no_grad()
    def prefill_chunk(self, params, tokens, req, off: int, tc: int) -> torch.Tensor:
        """One prefill chunk of ``req`` (``_prefill_chunk_impl``,
        backends.py:989-1071): attends over the slot's first ``off`` rows,
        gathered from its pages (``off`` is page-aligned), and the chunk;
        then writes the pages that hold the chunk's ``tc`` real rows.  JAX
        writes the chunk's full width, which past a prefix hit's
        reservation lands on table entries that name no page of this slot
        (page 0 by default); the port writes only the slot's reserved
        pages.  Returns (1, T, vocab) fp32 logits."""
        ps = self.page_size
        row = self.alloc.tables[req.slot]
        positions = off + torch.arange(tokens.shape[1], dtype=torch.int32, device=self.device)
        window = window_of(self.cfg)
        first_page = prefix_start(off, window) // ps
        prefix_ids = self._ids(row[first_page : off // ps])
        recorded = {}

        def attend(idx, q, k_new, v_new):
            recorded[idx] = (k_new, v_new)
            lp = self.pages[idx]

            def prefix(start):
                # The pages from start's on, cut to the rows from start.
                cut = start - first_page * ps
                return tuple(
                    _dequantize_rows(vals[:, prefix_ids], None if sc is None else sc[:, prefix_ids],
                                     2 if self.kv_int4 else None)
                    .reshape(vals.shape[0], off - first_page * ps, vals.shape[3])[None, :, cut:]
                    for vals, sc in ((lp.k, lp.k_scale), (lp.v, lp.v_scale))
                )

            return _chunk_prefix_attend(q, k_new, v_new, prefix, off, window,
                                        chunk_per_block(self.cfg))

        logits = llama.forward_chunk(params, tokens, positions, self.cfg, attend)
        n_pg = -(-tc // ps)
        own = row[off // ps : off // ps + n_pg]
        for idx, lp in enumerate(self.pages):
            k, v = recorded[idx]
            pgc.write_tokens(lp, own, 0, k[0, :, : n_pg * ps].float(), v[0, :, : n_pg * ps].float())
        self.alloc.lengths[req.slot] = off + tc
        return logits

    # -- decode ----------------------------------------------------------------

    def route(self, params) -> str:
        return "paged"

    def _load_tables(self) -> None:
        """The host allocator's tables and lengths into the device buffers,
        in place (a captured step keeps their addresses)."""
        self._tables.copy_(torch.from_numpy(self.alloc.tables))
        self._positions.copy_(torch.from_numpy(self.alloc.lengths))

    def _step(self, params, tokens: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One decode step over all slots from device tensors, with no host
        synchronisation (``_decode_step_impl``, backends.py:1209-1277): per
        layer, quantize each slot's k/v, write it at its position in the
        page ``tables[slot, pos // ps]`` (inactive lanes to the trash page;
        int4 pages by nibble writes, ``paged_cache.write_lanes``), then K10
        over the post-append lengths.  The rest of the step is
        ``llama.forward_decode`` (on a fused quantized tree the lean T=1
        decode with K8).  Advances the device positions of active slots.  Returns
        (B, vocab) fp32 logits."""
        ps = self.page_size
        positions = self._positions.clone()  # pre-append
        lengths = positions + active.to(torch.int32)  # post-append
        pos = positions.long()
        col = torch.clamp(pos // ps, max=self._tables.shape[1] - 1)
        page = self._tables.gather(1, col[:, None])[:, 0].long()
        page = torch.where(active, page, self._trash_page)
        row = pos % ps

        def attend(idx, q, k_new, v_new):
            lp = self.pages[idx]
            pgc.write_lanes(lp, page, row, k_new, v_new)
            return paged_decode_attention(
                q.to(torch.bfloat16).contiguous(), lp.k, lp.v, lengths, self._tables,
                k_scale_pages=lp.k_scale, v_scale_pages=lp.v_scale,
                pages_per_block=self._pages_per_block, window=window_of(self.cfg),
            )

        logits = llama.forward_decode(params, tokens, positions, self.cfg, attend)
        self._positions.copy_(lengths)
        return logits

    @torch.no_grad()
    def decode(self, params, tokens, active_mask, active_slots=None) -> torch.Tensor:
        """One decode step over all slots (host inputs), replayed from a
        graph on the card (``_run_step``) over the tables refreshed from the
        host allocator.  Returns (num_slots, vocab) fp32 logits."""
        mask = np.asarray(active_mask, bool)
        for slot in np.flatnonzero(mask):
            # Admission reserved the full footprint: a guard, no growth.
            self.alloc.allocate(int(slot), int(self.alloc.lengths[slot]) + 1, self.page_size)
        self._load_tables()
        logits = _run_step(self, params, tokens, mask)
        self.alloc.lengths[mask] += 1
        return logits

    @torch.no_grad()
    def burst(
        self, params, tokens, active, remaining, eos_ids, generator,
        n_steps: int, sp: SamplingParams, want_lp: bool,
    ) -> np.ndarray:
        """``n_steps`` decode steps on the device over the fixed tables
        (``burst``, backends.py:1515-1568): the packed trace, fetched once;
        the host lengths are then advanced by each slot's emitted count."""
        mask = np.asarray(active, bool)
        for slot in np.flatnonzero(mask):
            self.alloc.allocate(int(slot), int(self.alloc.lengths[slot]) + n_steps, self.page_size)
        self._load_tables()
        key = (id(params), sp, want_lp, self.route(params), config.snapshot())
        packed = _run_burst(self, key, params, tokens, active, remaining, eos_ids, generator,
                            n_steps, sp, want_lp)
        emits = packed[1] != 0.0 if want_lp else packed[1].astype(bool)
        self.alloc.lengths += emits.sum(axis=0).astype(np.int32)
        return packed

    # -- speculative decoding --------------------------------------------------

    @torch.no_grad()
    def verify(self, params, cand, positions, active_mask) -> torch.Tensor:
        """Grow every active slot's pages by the T candidates (pages drawn
        from the pool where the reservation does not cover them), write the
        candidates into them and score all T positions in one forward
        through K10's multi-query mode (``verify``, backends.py:1572-1605);
        inactive lanes write the trash page.  The host lengths stay as they
        were until ``rollback``.  Returns (num_slots, T, vocab) fp32
        logits."""
        tokens = _as_tensor(cand, torch.int64, self.device)
        t_width = tokens.shape[1]
        mask = np.asarray(active_mask, bool)
        for slot in np.flatnonzero(mask):
            self.alloc.allocate(int(slot), int(self.alloc.lengths[slot]) + t_width, self.page_size)
        self._load_tables()
        ps = self.page_size
        pos = torch.as_tensor(np.asarray(positions), dtype=torch.int32, device=self.device)
        active = torch.as_tensor(mask, device=self.device)
        lengths = pos + active.to(torch.int32) * t_width  # post-append
        pos2d = pos[:, None] + torch.arange(t_width, dtype=torch.int32, device=self.device)
        col = torch.clamp(pos2d.long() // ps, max=self._tables.shape[1] - 1)
        page = torch.where(active[:, None], self._tables.gather(1, col).long(), self._trash_page)
        row = pos2d.long() % ps

        def attend(idx, q, k_new, v_new):
            lp = self.pages[idx]
            pgc.write_block(lp, page, row, k_new, v_new)
            return paged_decode_attention(
                q.to(torch.bfloat16).contiguous(), lp.k, lp.v, lengths, self._tables,
                k_scale_pages=lp.k_scale, v_scale_pages=lp.v_scale,
                pages_per_block=self._pages_per_block, window=window_of(self.cfg),
            )

        return llama.forward_chunk(params, tokens, pos2d, self.cfg, attend)

    def rollback(self, rollback_mask, new_lengths) -> None:
        """Set the masked slots' host lengths to ``new_lengths``."""
        self.alloc.lengths = np.where(
            np.asarray(rollback_mask, bool), np.asarray(new_lengths, np.int32), self.alloc.lengths,
        ).astype(np.int32)

    # -- bookkeeping -------------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        return np.asarray(self.alloc.lengths).copy()

    def release(self, slot: int) -> None:
        self.alloc.release(slot)
