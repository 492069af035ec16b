"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of their own:

1. environment: torch, CUDA, nvcc, the card, and the kernels' build time
   (every kernel is built here from ``quantumattention_tpu_torch/csrc``);
2. K1 (flash forward): each instantiation's registers and spills
   (``k1_ptxas``); the kernel against its plain version and the fp32 SDPA
   oracle at the serving shapes, head dims 64/128/256 and 72/96/320/512
   (between and above the instantiated widths), bf16, fp16, fp32,
   e4m3 and int8 Q/K (head- and token-wise) and an e4m3 V; at the timed
   shape (B = 1, 32/8 heads, S = 1536, D = 128, causal) the device time by
   CUDA-graph replay (``ms``; ``call_ms`` adds the host's per-call work)
   of the fp8 and bf16 kernels, B = 4, q_offset 0 and 130 over the same
   tensors (``k1_offset``), and bf16 SDPA (flash and cuDNN back ends); then
   the original library's benchmark protocol (``k1_protocol``: B = 16,
   H = 16, S = 8192, D 64/128/256, causal and not, bf16 / fp8 head-wise /
   fp8 token-wise TFLOP/s beside SDPA flash and cuDNN, one batch entry and
   two heads against the fp32 oracle);
3. K4 (decode) over a ragged int8, bf16, packed int4 and e4m3 slot cache
   (4 slots of 0/57/900/2047 rows): the decode-attention core's registers
   and spills (``k4_ptxas``), the kernel against its plain version and the
   fp32 oracle, bitwise equal across two runs and under graph capture,
   device time by CUDA-graph replay with the cache cold in L2 (``ms``;
   ``call_ms`` by events with the host's work) beside the bound, and for
   the bf16 cache SDPA over the same rows with a length mask
   (``library_ms``); a float32 query over the int4 cache
   (``k4_f32_query``); then head dims 72/96/320/512 (``k4_width``; int4 and
   e4m3 too at 72 and 512), 32 query heads over one KV head
   (``k4_group``) and the speculative draft's width, head dim 64 at
   Llama-3.2-1B's heads (``k4_draft``); then verify mode (``k4_verify``:
   T = 2 and 5 candidates a head, GQA groups 1, 4 and 8, every cache
   kind, against the plain version; ``k4_verify_time``: T = 5, cold, by
   ``profiling.chain_bench``, beside the bound and SDPA with the
   (B, Hq, T, S) mask);
4. K1's residuals (m, l) against their plain version (D = 64/128/256; e4m3
   Q/K at the bars of fp8 tensor-core sums);
5. K2 (dQ) and K3 (dK, dV): each instantiation's registers and spills
   (``k23_ptxas``); against their plain version and against autograd of
   the fp32 oracle at D = 64/96/128/256/320/512 and GQA groups 1, 4 and 8,
   bitwise equal across two runs; at the timed shape device times by
   CUDA-graph replay (``ms``) and by CUDA events (``call_ms``), their plain
   versions and the fp8 path's whole backward; then the original library's protocol
   shape (``k23_protocol``: B = 16, H = 16, S = 8192, D = 128, causal) beside
   the SDPA flash and cuDNN backward, one batch entry and two heads against
   the oracle's autograd;
6. K5 (w8a16 product), K6 (its split-K schedule) and K7 (w4a16): the
   registers and spills of each instantiation of their kernel
   (``qmm_ptxas``, csrc/qgemm.cu); each against its plain version at
   Llama-3-8B's projection shapes (w_qkv, wo, w_gate_up, w_down, lm_head)
   and M = 4, 64 (the LM head at 64 slots), 80 (a paged verify pass) and
   1536, the route each took
   (``route_launches``: all three through the register-A wgmma kernel, K6
   with ``n_streams`` = 4), two runs and a graph-captured replay held
   bitwise equal, device times of kernel and plain version (CUDA graph
   replays; ``call_ms`` adds the host's per-call work), each product's
   bound, weight GB/s at decode rows, TFLOP/s and a bf16 ``torch.matmul``
   of the same shape (``bf16_gemm_ms``, context, not a port) at 1536 rows,
   and the library calls where the card's torch runs them:
   ``torch._weight_int8pack_mm`` beside K5 at w_gate_up (``k5_library``)
   and K6 at wo, w_qkv and w_down, M = 4 and 64 (``k6_library``),
   ``torch._weight_int4pack_mm`` beside K7 at w_gate_up (``k7_library``);
   then float32 rows through K5, K6 and K7 against their plain versions
   (``qmm_f32``);
7. K8 (the fused layer tail) against its plain version at Llama-3-8B's
   layer, int8 and int4, with and without the next layer's QKV, at M = 4,
   16, 64, 80 (a paged verify pass) and 256, with times as in 6, weight
   GB/s and the kernels launched per tail; at Phi-3-mini's layer (int8, M = 4, with the QKV); and one tail
   captured in a CUDA graph (its kernels use programmatic dependent launch)
   replayed against the eager call, bit for bit;
8. K9 (the fused decode layer) against its plain version at Llama-3-8B's
   layer, 16 slots / max_len 1024 and 64 / 512, ragged lengths with an
   empty slot: error, device time by graph replay (weights and cache cold
   in L2), the plain version's time, kernels a call, GB/s, the time of K8's
   stages alone, and two runs held bitwise equal (the per-kernel split of
   K8 and K9 runs last, see 17);
9. the engine: Llama-3-8B at full width and depth with seeded random bf16
   weights serves 6 greedy requests on 4 slots through K1 and K4; the
   launch counts prove the path went through the kernels, and each
   request's prefill logits are held against a plain-attention run; then
   the same tree and prompts decode in CUDA-graph bursts of 16
   (``engine_burst``: ms a burst step, K4 once a layer a step);
10. quantized serving: the same weights, quantized to int8 and fused
   (``fuse_projections(quantize_params(...))``), serve the 6 requests
   through K1, K4, K5/K6 and K8 (one K8 call per layer a decode step);
   then the int4 tree (``quantize_params_int4``) serves 3 through K7 and
   K8.  Prefill logits are held against the same tree run with plain
   attention and ``kernel.qmm = kernel.qmlp = False``, and one decode step
   through K8 against the unfused step on the same cache state; then one
   1536-token prefill forward of each tree (``quant_prefill``: device time
   over 3 forwards, 4 x 32 K5 or K7 launches at 1536 rows a forward);
11. ``serve_int8_64``, the JAX package's flagship serving point: the int8
   fused tree on 64 slots, max_len 512, 64 prompts of 128 tokens, 257 new
   tokens each, ``run_to_completion(decode_burst=64)``: prefill through K1
   and K5/K6, every decode step 32 K9 calls in CUDA-graph bursts with one
   host fetch each.  Checks: every request ends with 257 tokens, K9 ran 32
   times a decode step and K4/K8 never in them, one fetch a burst, prefill
   logits against the plain run, one K9 step of all 64 slots against the
   lean + K8 step, and a graph-captured burst of 8 steps against 8 eager
   steps, token for token;
12. K10 (paged decode) against its plain version and the fp32 oracle at
   Llama-3-8B's attention shapes: 16 slots over a shuffled page pool,
   ragged lengths up to 1024 with an empty slot, page sizes 128 and 256,
   int8 and bf16 pages (and int4 and e4m3 pages of 128), bitwise equal
   across two runs and under graph capture; device time by graph replay
   with the pool cold in L2 beside the bound, the plain version's time,
   GB/s, and K4 on the same rows laid out contiguously (what the gather
   costs); then ``k10_geometry`` (a GQA group of 32; pages of 8 and 512
   tokens; every page type, whether rows went by TMA or cp.async), and
   head dims 256 (``k10_d256``) and 72/96/320/512 (``k10_width``); verify
   mode as K4's (``k10_verify``, ``k10_verify_time``);
13. ``serve_paged_prefix_16``, the JAX package's prefix-caching point: the
   int8 fused tree on the paged backend (16 slots, max_len 1024, pages of
   128, chunks of 256, prefix cache, a pool of 192 pages), 16 prompts of
   512 tokens sharing a 384-token prefix, 129 new tokens each, bursts of
   64, served cold and then hot.  Checks: 129 tokens a request, prefix hits
   0 cold and 16 hot (6,144 tokens reused), K10 32 times a decode step and
   K4/K9 never in them, K1 in every chunk forward (q_offset > 0 in the
   second chunk cold and every hot chunk), one fetch a burst, hot logits
   against cold and cold against a plain whole-prompt run, one K10 step of
   16 slots against the same step through K10's plain version, and a graph
   burst of 8 steps against 8 eager steps;
    Then the low-bit caches end to end on the bf16 tree: ``serve_kv_int4``
   (the slots backend with ``kv_int4=True``, 3 requests; prefill logits
   against plain attention, one decode step through K4 against the step
   through K4's plain version), and ``serve_paged_int4`` /
   ``serve_paged_e4m3`` (the point above over int4 or e4m3 pages, cut to
   4 slots and 17 new tokens in bursts of 8: the same checks, with each
   round's final-chunk logits held against the same chunk through K1's
   plain version over the same quantized prefix);
    Then speculative decoding (``phase_speculative``, the ``spec_*``
   lines): Llama-3-8B with a draft at Llama-3.2-1B's published widths,
   greedy, 4 proposals a round, on 4 slots over int8, int4 and fp16 caches
   and the target drafting for itself, then the int8 fused tree on the
   paged backend at the prefix-caching point's geometry, with a small
   draft and with itself: K4 and K10 in verify mode (T = 5 candidates a
   head), each run beside the engine without a draft; every emitted token
   the argmax of its round's verify logits, verify logits within 5% of
   single plain steps, every page released;
14. ``serve_d256``: a 2-layer model of the Llama block at Gemma-7B's
   attention width (16 query heads of 256 over 8 KV heads, seeded random
   bf16 weights) serves 4 prompts on the paged backend in chunks of 128:
   K1 in every chunk forward (q_offset > 0 after the first), K10 in every
   decode step, no SDPA fallback, last logits against a plain-attention
   run; ``d96`` does the same at Phi-3-mini's attention width (32 query and
   32 KV heads of 96) and takes one training step through K1, K2 and K3 at
   D = 96, gradients against the plain path's;
15. training: the bf16 weights take 3 SGD steps over 1024 positions
   through the fp8 path (K1 forward, K1 recompute, K2 and K3 backward);
   the launch counts prove it, the first loss is held against the plain
   path's, and the gradients of a 4-layer cut against plain attention's;
16. SDPA's whole backward at K2/K3's timed shape by CUDA-graph replay, the
   library call beside both kernels (see ``phase_sdpa_backward``);
17. the per-kernel split of one K8 call (int8, M = 4/16/64/256, with and
   without the QKV), of one K6 call (wo, w_qkv, w_down at M = 4 and 64:
   the product and its reduction), of each tail product alone (M = 4 and 64) and of
   one K9 call, by ``torch.profiler`` (``split_k8``, ``split_k6``,
   ``split_product``, ``split_k9``), last so that the profiler stays out of
   the other phases' timings; ``python3 chip_smoke.py --split-only`` prints only these, on any
   tree of the port.

Sliding windows (after K10, and after training): the window checks of K1
(fp8 head-wise, token-wise and bf16 at B = 1, 32/8 heads, S = 1536,
windows (255, 0) and (1023, 0) causal and (128, 64) not, a chunk at
position 3000 over K/V cut to its window with ``kv_offset``; Mistral's
(4095, 0) at the protocol shape beside SDPA with the boolean window mask),
K2/K3 ((255, 0) causal, against the plain version and the oracle's
autograd), K4 (4 slots of 0/57/900/2047) and K10 (16 slots up to 1024),
windows of 256 and 1024 keys, every cache kind, T = 1 and 5, and K9 (16
slots / 1024, a window of 256), each timed beside the same call without
the window (``k1_window``, ``k1_window_protocol``, ``k23_window``,
``k4_window``, ``k10_window``, ``k9_window``); then Mistral-7B
(``llama.mistral_7b()``, full width and depth, seeded random weights):
``serve_mistral`` (bf16 tree, 4 slots of 8192 rows, int8 cache, prompts of
1000/4500/6000/7800 tokens, 64 new tokens a step at a time and then in
graph bursts of 16: K1 and K4 with the window, prefill logits against SDPA
with the window, one K4 step against its plain version, burst tokens equal
to the eager run's; the KV bytes a step reads with the window against the
whole cache), ``serve_mistral_paged`` (int8 fused tree, paged, 4 prompts
of 5000 tokens sharing 4096, chunks of 1024 over the prefix cut to the
window, cold then hot, K10 with the window), ``serve_mistral_mega`` (16
slots of 4300-token prompts, K9 with ``window_left`` 4095 in graph bursts,
one step against the unfused step) and ``mistral_train`` (one SGD step of
4 layers over 5120 positions through K1-K3 with the window, gradients
against the SDPA path's). The kernels line's ``launches_window`` counts
each of K1, K2, K3, K4, K9 and K10 on these paths; none may be 0.

K1's modes (after the autotuner, ``phase_k1_modes``): at the JAX
package's sparse benchmark (B = 4, H = 16, S = 8192, D = 128, bf16)
through ``attn_func``, dense non-causal, the block masks "documents"
(1024-token documents, density 1/8), "local+global" (8 causal granules, 2
global columns) and "random" (density 0.25, the diagonal kept), and the
documents as causal segment ids over seeded ragged lengths of 300-2000
tokens; int8 V (channel-wise) under int8 and e4m3 head-wise Q/K at B = 16,
H = 16, S = 8192, D = 128, causal.  Each ``k1_modes`` line: K1's device
time by graph replay and launches a call, the bound from the (query, key)
pairs the mask leaves, the density, one batch row and two heads against
the fp32 oracle (RMSE < 1e-2) and the plain version (1/32), and beside it
SDPA's memory-efficient back end with the expanded mask, flex_attention
with the same blocks where it compiles, or SDPA over the dequantized V;
then a graph-captured block-mask call against the eager one, bit for bit,
and rows that see no key (``k1_modes_zero_rows``).  The documents mask
must take under half the dense time.  The kernels line's K1 entry gains
``launches_segments``, ``launches_block_mask`` and ``launches_int8_v``
(one eager call of each case, counts reset just before) and ``modes``;
none of the three may be 0.  ``--k1-modes-only`` runs only this phase;
``--k1-dense-only`` prints only K1's ptxas lines and its dense times at
the timed shape (``k1_dense``), also over an earlier tree of the port.

Per-block scaling and the autotuner (after K1): the quantizer kernel
against its plain version bit for bit at the timed and protocol shapes
with its bytes bound (``block_quant``); K1 per-block against its plain
version and the fp32 oracle, each tile configuration within 1/32 of the
plain version and repeatable over two graph replays (``k1_block``), its
pre-pass and K1 timed apart (``k1_block_timing``, and per-block rows in
``k1_protocol``); the autotuner's sweeps of K1's tile configurations and
each configuration against the plain version, and of the "auto" path,
cache hits on second calls and nothing swept under graph capture
(``autotune`` lines); after the speculative runs, the engine phase's tree
served with "head-wise", "per-block" and "auto" (``serve_*_summary``,
``serve_prefill_forward``), then ``train_per_block`` after training and
``serve_mistral_per_block`` among the Mistral paths.  Each run sweeps from
an empty cache in a temporary directory and prints it at the end.

The parallel layer (after Mixtral, ``phase_parallel``): the unsharded
references here, then four ranks spawned on the one card over gloo (NCCL
refuses two ranks on one device), each holding only its shards: ring
attention at the original protocol's D = 128 causal cell (B = 16, H = 16,
S = 8192, sp = 4) in bf16, fp8 head-wise and fp8 token-wise, and at
Llama-3-8B's heads (32/8, B = 1, S = 8192) with the window (4095, 0);
Ulysses at the protocol cell; head-parallel fp8 at 32/8 heads; a 4-stage
pipeline of Llama-3-8B layers over 4 microbatches of 2048 rows;
Mixtral-8x7B layer 0's int8 experts at ep = 4; Llama-3-8B served at tp = 4
through ``Engine(mesh=)`` (the bf16 tree, the same in chunks of 512, the
unfused int8 tree).  One ``parallel`` line holds each case's error
against unsharded K1 or one card, the bytes staged through host memory
and the tp = 4 times beside one card's (four ranks sharing one card over
gloo: no scaling figure); the kernels line's ``launches_parallel`` counts
K1, K4, K5 and K6 over the ranks, none may be 0.  ``--parallel-only``
runs only this phase.

Training under a mesh (after the parallel layer, ``phase_parallel_train``):
one card's two SGD steps of each case on a batch of 2 x 1024 positions
(its step-1 gradients of the checked leaves and expert choices kept on the
host, then freed), then four ranks spawned on the card over gloo on a
(dp 2, tp 2) mesh, each holding its shards and its row, running
``llama.train_step(mesh=)`` twice: Llama-3-70B's widths
(``llama3_70b()``) cut to 2 layers in bf16, and Mixtral-8x7B's cut to 1
layer in fp8 head-wise (step 1 replaying one card's expert choices for the
rank's rows).  Checks: the step-1 loss within 1e-2 relative of one card's,
the same on every rank; the gradients ``train_step`` applies at step 1 of
layer 0's and the last layer's wq, wo and w_down (MoE: the experts'
w_down and the router), attn_norm, final_norm, the LM head and the
embedding rows of the batch's tokens, put back together from the shards,
within TRAIN_GRAD_BOUND relative Frobenius of one card's; dp replicas'
gradients and every replicated leaf (norms, routers) the same bytes on all
ranks; each rank's own expert choices equal across tp; K1, K2 and K3
launched on every rank, no SDPA fallback.  The ``parallel_train`` line
holds ms a step (step 2), tok/s, staged bytes, peak GB a rank and the
phase's wall beside one card's (four ranks sharing one card over gloo: no
scaling figure); the kernels line's ``launches_parallel`` of K1 adds this
phase's launches and K2's and K3's are this phase's.
``--parallel-train-only`` runs only this phase.

``python3 chip_smoke.py --engine-burst-only`` runs only the engine's burst
timing (``engine_burst``, phase 9), and ``--quant-prefill-only`` only the
quantized prefill timing (``quant_prefill``, phase 10), also over an
earlier tree of the port (a copy of this script beside that tree's
package); ``--serve-order-only`` serves the engine phase's tree with
"per-block" and "head-wise" in a fixed interleaved order
(``serve_order_*``: prefill tokens/s, each prefill's ms, the allocator's
and garbage collector's counters around each run).

Each model path resets the launch counts just before it runs and reads
them just after; the kernel phases' own launches do not count.

The last three lines are a JSON object with one entry per kernel (its
launches on the main path, error against its plain version, ms, plain ms,
``bound_ms``/``bound_by`` from the card's peaks and ``library_ms``, the
time of one PyTorch call computing the same function, or null), the
card's name and power limit (``nvidia-smi``), and ``{"ok": true,
"device": {...}}``.  Any failed check raises and the script exits
non-zero.  It needs one CUDA card and refuses to run without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from quantumattention_tpu_torch import autotune, config, dispatch
from quantumattention_tpu_torch.models import hf, llama, moe, quantized
from quantumattention_tpu_torch.ops import _native, megastep, qmlp, qmm, quant
from quantumattention_tpu_torch.ops.autodiff import attention_with_vjp, exact_attention_bwd
from quantumattention_tpu_torch.ops.decode import (
    KINDS,
    ROWS_PER_TILE,
    cache_kind,
    card_plan,
    decode_attention,
    decode_attention_plain,
    decode_schedule,
    kernel_query,
    window_left_of,
)
from quantumattention_tpu_torch.ops import flash as flash_mod
from quantumattention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_plain,
    kernel_window,
    keep_mask,
)
from quantumattention_tpu_torch.ops.paged import paged_decode_attention, paged_decode_attention_plain
from quantumattention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    pack_stats,
    row_delta,
)
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.parallel import mesh as mesh_lib
from quantumattention_tpu_torch.parallel import multihost
from quantumattention_tpu_torch.parallel.ep import expert_parallel_ffn
from quantumattention_tpu_torch.parallel.pp import pipeline_apply
from quantumattention_tpu_torch.parallel.ring import ring_attention
from quantumattention_tpu_torch.parallel.tp import head_parallel_attention
from quantumattention_tpu_torch.parallel.ulysses import ulysses_attention
from quantumattention_tpu_torch.serving import backends
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.utils import checks, profiling, shapes

#: The repository's accuracy bar: RMSE against the fp32 SDPA oracle.
RMSE_BAR = 1e-2
#: The bar also holds against the oracle on the unquantized inputs (fp8
#: rounding included) from this length up, as in the JAX suite's fp8 tests
#: (S >= 256).  At S = 57 the e4m3 rounding of q and k alone can exceed it:
#: short causal rows have sharp softmaxes.
FLOAT_BAR_MIN_SEQ = 256
#: Kernel against its plain version on the same inputs (bf16 outputs):
#: both round P to bf16 and the output to bf16, but sum in other orders,
#: so they may differ by a couple of bf16 ulps of values below 2.
KERNEL_VS_PLAIN_ATOL = 1.0 / 32
#: K4 and K10 against their plain version (bf16 outputs), tighter than the
#: bar above: a long slot's outputs on unit-normal inputs are about 0.05, as
#: small as 1/32.  Both round P and the output to bf16 and sum in other
#: orders; the card's largest differences were 1/256 at D <= 256 and 1/128
#: at D 320/512 (PERF.md section 6).  So max|a - b| within 1/64 overall, and
#: within each non-empty slot max|a - b| / max|b| within 2^-6 and
#: rmse(a, b) / rms(b) under 1e-2: a scale read from a neighbouring row, or
#: a tile dropped, moves a slot's relative error past them.
DECODE_VS_PLAIN_ATOL = 1.0 / 64
DECODE_SLOT_MAX_REL = 2.0 ** -6
DECODE_SLOT_RMS_REL = 1e-2
#: Engine prefill logits, fp8 kernel path against the plain fp32-attention
#: path on the same weights: ||a - b|| / ||b|| per request.  e4m3 keeps 3
#: mantissa bits, and the error of 32 random-weight layers adds up; a
#: broken kernel gives an error of order 1.
PREFILL_REL_BOUND = 0.1
#: K1's residuals against their plain version on the same inputs: the same
#: fp32 scores summed in another order (m absolute, l relative).
RESIDUAL_M_ATOL = 1e-3
RESIDUAL_L_RTOL = 1e-3
#: The same for e4m3 Q/K, whose Q.K^T now runs on the tensor cores in e4m3:
#: the fp8 wgmma sums its products with fewer bits than fp32 (about 14, the
#: DeepSeek-V3 report, section 3.3.2), a relative error near 2^-11 of a
#: score, so m (up to ~8 in the exp2 domain) may move by ~4e-3 and l by
#: ~3e-3 relative; the bars are twice that.
FP8_RESIDUAL_M_ATOL = 1.0 / 128
FP8_RESIDUAL_L_RTOL = 1e-2
#: K2/K3 against their plain version and the fp32 oracle's autograd:
#: max|a - b| / max|b|, the JAX suite's bar (tests/test_autodiff.py:27-30).
GRAD_BAR = 2e-2
#: Training: the first step's loss against the plain path's on the same
#: weights (relative), and the 4-layer gradients against plain attention's
#: (relative Frobenius norm): bf16 rounds P and dS where the plain path
#: keeps fp32; fp8 adds its straight-through estimate.
LOSS_REL_BOUND = 0.05
TRAIN_GRAD_BOUND = {"bf16": 5e-2, "fp8": 1e-1}
#: K5/K6/K7/K8 against their plain version (bf16 outputs): both sum in
#: fp32 and round once to bf16 (K8 at the same bf16 rounding points), in
#: other orders: max|a - b| / max|b| within 2^-6, a couple of bf16 ulps at
#: the largest magnitude.
QUANT_KERNEL_REL = 2.0 ** -6
#: One decode step through K8 against the unfused step (``kernel.qmlp =
#: False``: K5/K6 products, PyTorch norms and SwiGLU) on the same cache
#: state and weights, ||a - b|| / ||b|| per slot.  The rounding points are
#: the same; fp32 sums in other orders flip single bf16 ulps, and 32
#: random-weight layers carry them to the logits.  A wrong tail is off by
#: order 1.
DECODE_K8_REL_BOUND = 0.05
#: K9 at Llama-3-8B's layer: (slots, max_len) of the JAX package's two
#: serving points (bench.py:174-228).
K9_SHAPES = ((16, 1024), (64, 512))
#: The flagship serving point (bench.py:174-241, ``serve_point(64, 512,
#: 128)``): 64 slots, max_len 512, 64 prompts of 128 tokens in buckets of
#: 128, 257 new tokens each, bursts of 64.
SERVE64 = {"slots": 64, "max_len": 512, "prompt": 128, "new": 257, "burst": 64,
           "bucket": 128}
#: Eager per-step mega calls the graph-captured burst is held against.
BURST_CHECK_STEPS = 8
#: K10 at Llama-3-8B's attention: slots, max_len, page sizes, spare pages.
K10_SLOTS, K10_MAX_LEN, K10_PAGE_SIZES, K10_SPARE_PAGES = 16, 1024, (128, 256), 64
#: Fault 11's geometry at Llama-3-8B's head dim: (q heads, KV heads, page
#: size) for a GQA group of 32 and pages of 8 and 512 tokens.
K10_GEOMETRY = ((32, 1, 128), (32, 8, 8), (32, 8, 512))
#: The JAX package's prefix-caching point (benchmarks/prefix_cache_bench.py:
#: 28-47): 16 slots, max_len 1024, pages of 128, chunks of 256, a pool of
#: 16 * 8 + 64 pages, 16 prompts of 512 tokens sharing 384, 129 new tokens.
PAGED16 = {"slots": 16, "max_len": 1024, "page_size": 128, "chunk": 256, "num_pages": 192,
           "prompt": 512, "shared": 384, "new": 129, "burst": 64}
#: The same point over int4 and e4m3 pages (fault 12), cut to 4 slots and
#: 17 new tokens in bursts of 8 to stay inside the run's time.
LOWBIT_PAGED = {"slots": 4, "max_len": 1024, "page_size": 128, "chunk": 256, "num_pages": 48,
                "prompt": 512, "shared": 384, "new": 17, "burst": 8, "same_path_check": True}
#: The card's peaks for ``bound_ms`` (NVIDIA's H100 SXM data sheet,
#: dense): device memory bytes/s and tensor-core operations/s by operand type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp8": 1979e12}
#: K5-K7's rows: a decode step at 4 slots, the LM head at 64 slots, a
#: verify pass of 16 slots x 5 candidates (``phase_speculative``'s paged
#: run), and a 1536-token prefill.
QMM_ROWS = (4, 64, 80, 1536)
#: K5/K7 over float32 rows (fault 10) against their plain version:
#: max|a - b| / max|b|, the CPU suite's fp32 bar (tests/test_torch_qmm.py:
#: the same fp32 products summed in another order).
QMM_F32_REL = 1e-5
#: The quantized prefill timed in ``quant_prefill``: one prompt of 1536
#: tokens (batch 1) through the fused int8 and int4 Llama-3-8B trees,
#: 3 forwards after a warm-up.
QUANT_PREFILL = {"tokens": 1536, "reps": 3}
#: At decode rows each weight is read once a step, from device memory: the
#: timed calls cycle through copies of a weight that together exceed this
#: (2.5x the H100's 50 MB L2 cache), so no call finds its weight cached.
COLD_BYTES = 128e6
#: K8's rows: decode steps of 4, 16 and 64 slots, a verify pass of 16
#: slots x 5 candidates, a prefill chunk of 256.
TAIL_ROWS = (4, 16, 64, 80, 256)
#: K8 at Phi-3-mini's layer (microsoft/Phi-3-mini-4k-instruct config.json:
#: hidden 3072, intermediate 8192, 32 heads of 96 with as many KV heads).
PHI3_TAIL = {"E": 3072, "I": 8192, "Q": 3072, "F": 9216}
SERVE_PROMPTS = [57, 128, 300, 300, 900, 1500]
SERVE_PROMPTS_INT4 = [57, 300, 900]
#: The engine phase's tree and prompts decoded in graph-captured bursts of
#: 16 steps, 64 new tokens a request (the 4-slot end-to-end number K4 moves).
ENGINE_BURST = {"burst": 16, "new": 64}
TRAIN_POSITIONS = 1024
TRAIN_STEPS = 3
GRAD_CHECK_LAYERS = 4
#: The head-dim-256 model check: the Llama block at Gemma-7B's attention
#: width (16 query heads of 256, hidden 3072, intermediate 24576), 8 KV
#: heads, cut to 2 layers; 4 prompts longer than a chunk on the paged backend,
#: in chunks of 128.
D256_MODEL = {"num_layers": 2, "hidden_size": 3072, "intermediate_size": 24576,
              "num_q_heads": 16, "num_kv_heads": 8, "head_dim": 256}
D256_PROMPTS = [150, 200, 300, 450]
#: How the head-dim model checks (serve_d256, d96) serve: paged, pages of
#: 128, chunks of 128, 9 new tokens.
WIDTH_SERVE = {"max_len": 1024, "page_size": 128, "chunk": 128, "new": 9}
#: The head-dim-96 model check: the Llama block at Phi-3-mini's published
#: width (microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32
#: attention and 32 KV heads of 96, intermediate 8192, vocab 32064), cut to
#: 2 layers; prompts on the paged backend in chunks of 128, then one
#: training step over 512 positions.
D96_MODEL = {"num_layers": 2, "hidden_size": 3072, "intermediate_size": 8192,
             "num_q_heads": 32, "num_kv_heads": 32, "head_dim": 96, "vocab_size": 32064}
D96_PROMPTS = [150, 260, 333]
D96_TRAIN_POSITIONS = 512
#: Head dims between and above the kernels' instantiated widths (64, 128,
#: 256, 512) that the K1, K10 and K2/K3 phases check.
ANY_WIDTHS = (72, 96, 320, 512)
#: Head dims at which K4 and K10 also run over int4 and e4m3 caches.
LOWBIT_WIDTHS = (72, 512)
#: The original library's benchmark protocol (its bench.py:1-5, SURVEY.md
#: section 6): batch 16, 16 heads (MHA), 8192 positions, head dims 64/128/256.
PROTOCOL = {"B": 16, "H": 16, "S": 8192, "D": (64, 128, 256)}

K1_SOURCE = "quantumattention_tpu_torch/csrc/flash_fwd.cu"
K4_SOURCE = "quantumattention_tpu_torch/csrc/decode.cu"
K23_SOURCE = "quantumattention_tpu_torch/csrc/flash_bwd.cu"
QGEMM_SOURCE = "quantumattention_tpu_torch/csrc/qgemm.cu"
K8_SOURCE = "quantumattention_tpu_torch/csrc/qmlp.cu"
K1_REPLACES = "quantumattention_tpu/ops/flash.py:123"
K4_REPLACES = "quantumattention_tpu/ops/decode.py:56"
K2_REPLACES = "quantumattention_tpu/ops/flash_bwd.py:112"
K3_REPLACES = "quantumattention_tpu/ops/flash_bwd.py:150"
K5_REPLACES = "quantumattention_tpu/ops/qmm.py:49"
K6_REPLACES = "quantumattention_tpu/ops/qmm.py:70"
K7_REPLACES = "quantumattention_tpu/ops/qmm.py:118"
K8_REPLACES = "quantumattention_tpu/ops/qmlp.py:93"
K9_SOURCE = "quantumattention_tpu_torch/csrc/megastep.cu"
K9_REPLACES = "quantumattention_tpu/ops/megastep.py:72"
K10_SOURCE = "quantumattention_tpu_torch/csrc/paged.cu"
K10_REPLACES = "quantumattention_tpu/ops/paged.py:77"
#: The float caches K4 and K10 take without scales (fault 13: float16 and
#: float32 beside bf16).
FLOAT_CACHES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
#: Verify mode (speculative decoding): candidates a head, GQA groups and
#: cache kinds held against the plain versions; the timed point is T = 5
#: (spec_tokens = 4) at Llama-3-8B's group of 4.
VERIFY_T, VERIFY_G = (2, 5), (1, 4, 8)
VERIFY_KINDS = ("int8", "e4m3", "int4", "bf16", "f16", "f32")
VERIFY_TIMED_T = 5
#: The draft of the speculative phase: a Llama at Llama-3.2-1B's published
#: widths (meta-llama/Llama-3.2-1B config.json: vocab 128256, hidden 2048,
#: intermediate 8192, 16 layers, 32 query and 8 KV heads of 64, rope theta
#: 500000, tied embeddings), weights seeded; its llama3 rope scaling is not
#: modelled.
DRAFT_1B = {"vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192, "num_layers": 16,
            "num_q_heads": 32, "num_kv_heads": 8, "head_dim": 64, "rope_theta": 500000.0,
            "tie_embeddings": True}
#: The speculative runs: (a) the engine phase's 4 slots and prompts, 64 new
#: tokens each; (b)-(c) 2 of its requests; (d) serve_paged_prefix_16's
#: geometry with 33 new tokens.
SPEC = {"slots": 4, "max_len": 2048, "new": 64, "gamma": 4, "few": 2}
SPEC_PAGED = dict(PAGED16, new=33)
#: Mistral-7B (``llama.mistral_7b()``: mistralai/Mistral-7B-v0.1's published
#: widths and its 4096-token sliding window), seeded random weights at full
#: depth.  serve_mistral: the bf16 tree on the slots backend, 4 slots of
#: 8192 rows, prompts on both sides of the window, 64 new tokens a step at
#: a time, then in bursts of 16.
MISTRAL_SLOTS = {"slots": 4, "max_len": 8192, "prompts": (1000, 4500, 6000, 7800), "new": 64,
                 "burst": 16}
#: serve_mistral_paged: the int8 fused tree on the paged backend, 4 prompts
#: of 5000 tokens sharing 4096 (one window), chunks of 1024, pages of 128,
#: the prefix cache, cold then hot; the plain run one prompt at a time.
MISTRAL_PAGED = {"slots": 4, "max_len": 6144, "page_size": 128, "chunk": 1024, "num_pages": 4 * 48 + 1,
                 "prompt": 5000, "shared": 4096, "new": 33, "burst": 16, "plain_rows": 1}
#: serve_mistral_mega: the int8 fused tree on 16 slots of 4608 rows, prompts
#: of 4300 tokens (past the window), 48 new tokens in bursts of 16 (K9): the
#: first burst captures the step's graph, later ones replay it and are timed.
MISTRAL_MEGA = {"slots": 16, "max_len": 4608, "prompt": 4300, "new": 48, "burst": 16}
#: The training check: one SGD step of mistral_7b(num_layers=4) over 5120
#: positions, past the window.
MISTRAL_TRAIN = {"layers": 4, "positions": 5120}
#: The window checks: K1 at B = 1, 32/8 heads, S = 1536, D = 128 as
#: (causal, window, q_offset, kv_offset): causal windows of 256 and 1024
#: keys, a non-causal one, and a chunk at position 3000 over K/V cut to its
#: window (K from position 1977 on); K4 and K10 windows of 256 and 1024
#: keys; Mistral's window at the protocol shape; K9's window of 256 keys.
WINDOW_K1 = ((True, (255, 0), 0, 0), (True, (1023, 0), 0, 0), (False, (128, 64), 0, 0),
             (True, (1023, 0), 3000, 1977))
WINDOW_LEFTS = (255, 1023)
WINDOW_PROTOCOL_LEFT = 4095
K9_WINDOW = 256
#: Per-block quantization and the autotuner: the quantizer (the
#: pre-pass of K1's per-block mode) and its cases (B, H, S, D, block rows).
BLOCK_QUANT_SOURCE = "quantumattention_tpu_torch/csrc/block_quant.cu"
BLOCK_QUANT_REPLACES = "quantumattention_tpu/ops/flash.py:227"
BLOCK_QUANT_CASES = ((1, 32, 1536, 128, 1024), (1, 8, 1536, 128, 1536), (1, 32, 1536, 96, 1024),
                     (1, 32, 1000, 128, 1024), (2, 8, 777, 72, 128),
                     *((16, 16, 8192, d, b) for d in (64, 128, 256) for b in (1024, 2048)))
#: k1_block cases at B = 1, 32/8 heads: (Sq, Skv, D, causal, window, q_offset, kv_offset).
K1_BLOCK_CASES = ((1536, 1536, 128, True, None, 0, 0), (1536, 1536, 128, True, (255, 0), 0, 0),
                  (512, 712, 128, True, None, 3000, 2800), (1000, 1000, 128, True, None, 0, 0),
                  (1536, 1536, 128, False, None, 0, 0),
                  *((512, 512, d, True, None, 0, 0) for d in (72, 96, 320, 512)))
#: The shapes the autotune lines sweep: (B, Hq, Hkv, S, D).
AUTOTUNE_SHAPES = ((1, 32, 8, 1536, 128), (16, 16, 16, 8192, 64), (16, 16, 16, 8192, 128))
#: K1's modes (phase_k1_modes): the JAX package's sparse benchmark
#: (benchmarks/sparse_bench.py:68-124: B = 4, H = 16, S = 8192, D = 128,
#: bf16; documents of 1024 tokens, 8 local causal granules and 2 global
#: columns, a random mask at density 0.25), segment ids over seeded ragged
#: documents of 300-2000 tokens, and int8 V at the protocol's causal D = 128
#: cell; one batch row and two heads are held against the oracle and the
#: plain version.
K1_MODES = {"B": 4, "H": 16, "S": 8192, "D": 128, "doc": 1024, "local": 8, "global": 2,
            "density": 0.25, "doc_min": 300, "doc_max": 2000}
K1_INT8_V = {"B": 16, "H": 16, "S": 8192, "D": 128}

#: Mixtral-8x7B (``phase_mixtral``): the slots point (the engine phase's
#: prompts, then graph bursts of 16), the paged point (LOWBIT_PAGED's
#: shape), one MoE layer at decode rows (4 tokens: capacity 8) and prefill
#: rows (1500 tokens: capacity 472), training, and the checkpoint
#: directory (full width, one layer).
MIXTRAL_SERVE = {"slots": 4, "max_len": 2048, "burst": 16}
MIXTRAL_PAGED = dict(LOWBIT_PAGED)
MIXTRAL_LAYER_TOKENS = (4, 1500)
MIXTRAL_TRAIN = {"layers": 2, "positions": 1024, "steps": 2}
MIXTRAL_HF = {"layers": 1, "prompts": (40, 300), "new": 8}
#: Seeds of each fuzz draw (tests/torch_fuzz_draws.py) in ``phase_fuzz``.
FUZZ_SEEDS = 4

def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 10, iters: int = 20) -> float:
    """Mean device time of one call in ms: ``reps`` calls, cycling through
    ``fns`` (one callable or a list), captured in one CUDA graph and
    replayed ``iters`` times between CUDA events, so the host's per-call
    work (Python checks, ctypes, allocation) is left out.  At decode shapes
    that work takes longer than the kernels themselves."""
    fns = fns if isinstance(fns, list) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def bound(nbytes: float, ops=None) -> dict:
    """The least time the card could take: the larger of ``nbytes`` at the
    memory rate and the operations (``{"bf16": n, "fp8": n}``) at their
    types' peaks."""
    byte_ms = 1e3 * nbytes / HBM_BYTES_S
    op_ms = 1e3 * sum(n / PEAK_OPS_S[kind] for kind, n in (ops or {}).items())
    return {"bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def sdpa_library_ms(gen, b: int, s: int, d: int, causal: bool) -> float:
    """bf16 ``scaled_dot_product_attention`` with the flash and cuDNN back
    ends at (b, 32 q heads, s, d) over 8 KV heads: the yardstick of K1, used
    nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = _randn((b, 32, s, d), gen), _randn((b, 8, s, d), gen), _randn((b, 8, s, d), gen)
    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]):
        return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    return max_abs(a, b) / float(b.float().abs().max())


def decode_vs_plain(out: torch.Tensor, plain: torch.Tensor, lens) -> dict:
    """K4's or K10's (B, Hq, D) output against its plain version: the
    largest difference, and the worst slot's max|a - b| / max|b| and
    rmse(a, b) / rms(b) over the slots of non-zero length."""
    diff = out.float() - plain.float()
    rec = {"max_abs_vs_plain": float(diff.abs().max()), "slot_max_rel_vs_plain": 0.0,
           "slot_rms_rel_vs_plain": 0.0}
    for i, n in enumerate(lens):
        if n:
            ref = plain[i].float()
            rec["slot_max_rel_vs_plain"] = max(rec["slot_max_rel_vs_plain"],
                                               float(diff[i].abs().max() / ref.abs().max()))
            rec["slot_rms_rel_vs_plain"] = max(rec["slot_rms_rel_vs_plain"],
                                               float(diff[i].pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()))
    return rec


def decode_close(rec: dict) -> bool:
    """``rec`` (of :func:`decode_vs_plain`) within the decode bars."""
    return (rec["max_abs_vs_plain"] <= DECODE_VS_PLAIN_ATOL
            and rec["slot_max_rel_vs_plain"] <= DECODE_SLOT_MAX_REL
            and rec["slot_rms_rel_vs_plain"] < DECODE_SLOT_RMS_REL)


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env() -> dict:
    nvcc = subprocess.run(
        [_native._find_nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _native.library()
    load_s = time.perf_counter() - t0
    info = _native.build_info()
    env = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc,
        "device": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "build_s": info["seconds"],
        "build_and_load_s": load_s,
    }
    log("env " + json.dumps(env))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("ptxas " + line.strip())
    if not checks.is_hopper(0):
        raise RuntimeError(f"the kernels are built for sm_90a; card is {env['capability']}")
    return env


def plain_k4_call(q, k, v, lengths, *, k_scale, v_scale, window=None):
    """K4's plain version under the keywords the backends call K4 with."""
    return decode_attention_plain(q, k, v, lengths, k_scale, v_scale,
                                  window_left=window_left_of(window, "decode_attention"))


def plain_k10_call(q, k, v, lengths, table, *, k_scale_pages, v_scale_pages, pages_per_block,
                   window=None):
    """K10's plain version under the keywords the backends call K10 with."""
    return paged_decode_attention_plain(q, k, v, lengths, table, k_scale_pages, v_scale_pages,
                                        window_left=window_left_of(window, "paged_decode_attention"))


@contextlib.contextmanager
def _uncaptured():
    """The backends' decode steps and bursts uncaptured inside (``_graphs``
    false): once a step's key is captured, ``decode`` replays its graph,
    which runs none of the Python a plain reference switches (a swapped
    module attribute, a routing hook).  The kernel side of a comparison
    keeps ``decode``, so its replay is what is checked, except where a
    routing hook must run in it."""
    graphs = backends._graphs
    backends._graphs = lambda backend: False
    try:
        yield
    finally:
        backends._graphs = graphs


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _k1_inputs(b, s, mode, d, gen, hq=32, hkv=8, skv=None):
    """(args, scales, float q/k/v) of one K1 case: float inputs of the
    mode's type ("fp16", "fp32", else bf16), quantized to e4m3 ("head",
    "token") or int8 ("int8") with scales, or an e4m3 V ("e4m3v")."""
    fdt = {"fp16": torch.float16, "fp32": torch.float32}.get(mode, torch.bfloat16)
    skv = s if skv is None else skv
    q, k, v = _randn((b, hq, s, d), gen, fdt), _randn((b, hkv, skv, d), gen, fdt), _randn((b, hkv, skv, d), gen, fdt)
    if mode in ("head", "token", "int8"):
        quantize = quant.quantize_token_wise if mode == "token" else quant.quantize_head_wise
        qdt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
        (q8, sq), (k8, sk) = quantize(q, qdt), quantize(k, qdt)
        return (q8, k8, v), {"scale_q": sq, "scale_k": sk}, (q, k, v)
    if mode == "e4m3v":
        return (q, k, v.to(torch.float8_e4m3fn)), {}, (q, k, v)
    return (q, k, v), {}, (q, k, v)


def _visible_pairs(sq: int, skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs the mask leaves: the products' work is 2 * D flops a pair each."""
    if not causal:
        return sq * skv
    return sum(min(skv, q_offset + i + 1) for i in range(sq))


def _ptxas(kernel: str, params=("W", "code")) -> list:
    """Registers and spills of each instantiation of the kernels whose name
    matches ``kernel`` from the build's ptxas output, with its integer
    template arguments under ``params`` (width W and element code for K1-K3;
    W, NG and mode for the decode-attention core; none for its merge)."""
    args = "".join(r"ILi(\d+)E" if i == 0 else r"Li(\d+)E" for i in range(len(params)))
    rows, cur = [], None
    for line in _native.build_info()["log"].splitlines():
        # A trailing bool argument (the decode core's verify mode) as "multi".
        m = re.search(r"Function properties for \S*?(" + kernel + r")" + args + r"(?:Lb(\d)E)?", line)
        if m:
            cur = {"kernel": m.group(1), **{k: int(v) for k, v in zip(params, m.groups()[1:])}}
            if m.group(len(params) + 2) is not None:
                cur["multi"] = int(m.group(len(params) + 2))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            rows.append(cur)
            cur = None
    return rows


def phase_k1(gen) -> dict:
    """K1 against its plain version and the fp32 oracle at the serving
    shapes, head dims 64/128/256 and every operand type; device times by
    graph replay at the timed shape (fp8 head-wise, bf16, q_offset 0 and
    130, B = 4); then the original library's benchmark protocol."""
    for row in _ptxas("flash_fwd_kernel", ("W", "code", "tiles")):
        log("k1_ptxas " + json.dumps(row))
    cases = [
        (b, s, mode, True, 128)
        for b in (1, 4) for s in (57, 512, 1536) for mode in ("bf16", "head", "token")
    ]
    cases += [(1, 512, "head", False, 128), (1, 512, "head", True, 64),
              (1, 512, "fp16", True, 128), (1, 512, "int8", True, 128),
              (1, 512, "e4m3v", True, 128), (1, 512, "fp32", True, 128),
              (1, 512, "bf16", True, 256), (1, 512, "head", True, 256),
              (1, 512, "token", False, 256), (1, 512, "fp32", True, 256),
              (1, 512, "fp16", False, 64), (1, 512, "int8", False, 256)]
    # Head dims between and above the instantiated widths: zero columns past
    # D, 8-bit Q/K of D % 16 == 8 zero-padded by the wrapper, two CTAs a Q
    # block at 320 and 512.
    cases += [(1, 512, mode, True, d) for d in ANY_WIDTHS for mode in ("bf16", "head", "token")]
    cases += [(1, 512, "int8", False, 72), (1, 512, "e4m3v", True, 96),
              (1, 512, "fp16", True, 320), (1, 512, "fp32", False, 512), (4, 57, "head", True, 96)]
    worst = {}
    timing = None
    for b, s, mode, causal, d in cases:
        args, scales, floats = _k1_inputs(b, s, mode, d, gen)
        out = flash_attention(*args, is_causal=causal, **scales)
        plain = flash_attention_plain(*args, is_causal=causal, **scales)
        # The fp32 oracle on the kernel's own (dequantized) inputs, and on
        # the float inputs before quantization (the fp8 format's own error).
        oracle = sdpa_reference(*args, is_causal=causal, out_dtype=torch.float32, **scales)
        oracle_float = sdpa_reference(*floats, is_causal=causal, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = max_abs(out, plain)
        r = rmse(out, oracle)
        r_float = rmse(out, oracle_float)
        finite = bool(torch.isfinite(out).all())
        rec = {"B": b, "S": s, "D": d, "mode": mode, "causal": causal, "out_dtype": str(out.dtype),
               "max_abs_vs_plain": err, "rmse_vs_oracle": r,
               "rmse_vs_float_oracle": r_float}
        if (b, s, causal, d) in ((1, 1536, True, 128), (4, 1536, True, 128)) and mode != "token":
            fn = functools.partial(flash_attention, *args, is_causal=causal, **scales)
            rec["ms"] = graph_ms(fn)
            rec["call_ms"] = time_ms(fn)
            rec["plain_ms"] = time_ms(lambda: flash_attention_plain(*args, is_causal=causal, **scales), iters=5)
            rec["kernel_tflops"] = 4 * b * 32 * _visible_pairs(s, s, causal) * d / rec["ms"] / 1e9
            if (b, mode) == (1, "head"):
                timing = rec
        log("k1 " + json.dumps(rec))
        if (not finite or err > KERNEL_VS_PLAIN_ATOL or not r < RMSE_BAR
                or (s >= FLOAT_BAR_MIN_SEQ and not r_float < RMSE_BAR)):
            raise RuntimeError(f"K1 disagrees: {rec}")
        worst[d] = max(worst.get(d, 0.0), err)
        del args, scales, floats, out, plain, oracle, oracle_float
    log("k1 max_abs_vs_plain_by_D " + json.dumps(worst))
    _k1_offset_timing(gen)
    torch.cuda.empty_cache()
    _k1_protocol(gen)
    # Bound at the timed shape (1, 1536, head-wise e4m3 q and k, bf16 v,
    # causal): q, k (1 byte), v and out (2 bytes); Q.K^T at the fp8 peak,
    # P.V at bf16's, each 2 * D flops a visible (query, key) pair.
    s, d = 1536, 128
    nbytes = 32 * s * d * (1 + 2) + 8 * s * d * (1 + 2)
    half = 2 * 32 * _visible_pairs(s, s, True) * d
    lib = sdpa_library_ms(gen, 1, s, d, True)
    log(f"k1 library sdpa_bf16_ms={lib}")
    return {"max_abs_err": max(worst.values()), "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            **bound(nbytes, {"fp8": half, "bf16": half}), "library_ms": lib}


def _k1_offset_timing(gen) -> None:
    """K1 at the timed shape with q_offset 0 and 130 over the same tensors
    (K/V 130 rows longer than Q, as a chunk after a 130-token prefix): the
    offset's arithmetic must cost nothing at 0."""
    s, d, off = 1536, 128, 130
    args, scales, _ = _k1_inputs(1, s, "head", d, gen, skv=s + off)
    for q_offset in (0, off):
        fn = functools.partial(flash_attention, *args, is_causal=True, q_offset=q_offset, **scales)
        out = fn()
        plain = flash_attention_plain(*args, is_causal=True, q_offset=q_offset, **scales)
        torch.cuda.synchronize()
        rec = {"B": 1, "Sq": s, "Skv": s + off, "D": d, "mode": "head", "q_offset": q_offset,
               "max_abs_vs_plain": max_abs(out, plain), "ms": graph_ms(fn)}
        rec["kernel_tflops"] = 4 * 32 * _visible_pairs(s, s + off, True, q_offset) * d / rec["ms"] / 1e9
        log("k1_offset " + json.dumps(rec))
        if not bool(torch.isfinite(out).all()) or rec["max_abs_vs_plain"] > KERNEL_VS_PLAIN_ATOL:
            raise RuntimeError(f"K1 with q_offset disagrees: {rec}")
        del out, plain


def _k1_protocol(gen) -> None:
    """The original library's benchmark protocol: B = 16, H = 16 (MHA),
    S = 8192, D 64/128/256, causal and not, K1 in bf16, fp8 head-wise,
    fp8 token-wise and fp8 per-block (the whole call, and its pre-pass and
    K1 timed apart), beside SDPA's flash and cuDNN back ends timed apart
    (cuDNN only where it takes D). TFLOP/s = 4 B H S^2 D, halved under the
    causal mask. The plain version would need 68 GB of fp32 scores here:
    one batch entry and two heads are held against the fp32 oracle (on
    the float inputs for per-block)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, h, s = PROTOCOL["B"], PROTOCOL["H"], PROTOCOL["S"]
    for d in PROTOCOL["D"]:
        q, k, v = (_randn((b, h, s, d), gen) for _ in range(3))
        (qh, sqh), (kh, skh) = (quant.quantize_head_wise(t, torch.float8_e4m3fn) for t in (q, k))
        (qt, sqt), (kt, skt) = (quant.quantize_token_wise(t, torch.float8_e4m3fn) for t in (q, k))
        runs = {
            "bf16": ((q, k, v), {}),
            "fp8_head": ((qh, kh, v), {"scale_q": sqh, "scale_k": skh}),
            "fp8_token": ((qt, kt, v), {"scale_q": sqt, "scale_k": skt}),
        }
        for causal in (True, False):
            flops = 4 * b * h * s * s * d / (2 if causal else 1)
            rec = {"B": b, "H": h, "S": s, "D": d, "causal": causal}
            for name, (args, scales) in runs.items():
                out = flash_attention(*args, is_causal=causal, **scales)
                cut = [a[:1, :2] for a in args]
                cut_scales = {key: t[:1, :2] for key, t in scales.items()}
                oracle = sdpa_reference(*cut, is_causal=causal, out_dtype=torch.float32, **cut_scales)
                rec[f"{name}_rmse_vs_oracle"] = rmse(out[:1, :2], oracle)
                if not bool(torch.isfinite(out).all()) or not rec[f"{name}_rmse_vs_oracle"] < RMSE_BAR:
                    raise RuntimeError(f"K1 disagrees at the protocol shape: {rec}")
                del out, oracle
                ms = time_ms(functools.partial(flash_attention, *args, is_causal=causal, **scales),
                             iters=3, warmup=1)
                rec[f"{name}_ms"], rec[f"{name}_tflops"] = ms, flops / ms / 1e9
            rec.update(_k1_block_protocol(q, k, v, causal, flops))
            for name, backend in (("sdpa_flash", SDPBackend.FLASH_ATTENTION),
                                  ("sdpa_cudnn", SDPBackend.CUDNN_ATTENTION)):
                try:
                    with sdpa_kernel([backend]):
                        ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                            q, k, v, is_causal=causal), iters=3, warmup=1)
                except RuntimeError as e:  # the back end refuses this head dim
                    rec[f"{name}_ms"] = rec[f"{name}_tflops"] = None
                    rec[f"{name}_refused"] = str(e).splitlines()[0][:120]
                    continue
                rec[f"{name}_ms"], rec[f"{name}_tflops"] = ms, flops / ms / 1e9
            rec["fp8_head_over_sdpa_flash"] = rec["fp8_head_tflops"] / rec["sdpa_flash_tflops"]
            log("k1_protocol " + json.dumps(rec))
        del q, k, v, qh, kh, qt, kt, runs
        torch.cuda.empty_cache()


def _k1_block_protocol(q, k, v, causal: bool, flops: float) -> dict:
    """K1 per-block at the protocol shape: one batch entry and two heads
    against the fp32 oracle on the float inputs (the blocks are per head,
    so the cut's quantization is the whole call's), the whole call's time
    (its tile sweep untimed), the pre-pass and K1 apart."""
    bq, bkv = flash_mod.block_sizes(q.shape[2], k.shape[2], q.shape[-1])
    call = functools.partial(flash_attention, q, k, v, fused_block_quant=True, is_causal=causal)
    out = call()
    oracle = sdpa_reference(q[:1, :2], k[:1, :2], v[:1, :2], is_causal=causal,
                            out_dtype=torch.float32)
    # Head-wise e4m3 on the same float inputs, beside it (its own line holds
    # it against the oracle on its quantized inputs).
    head = dispatch.fp8_attention(q[:1, :2], k[:1, :2], v[:1, :2], is_causal=causal)
    rec = {"fp8_block_rmse_vs_oracle": rmse(out[:1, :2], oracle),
           "fp8_head_rmse_vs_float_oracle": rmse(head, oracle)}
    if not bool(torch.isfinite(out).all()) or not rec["fp8_block_rmse_vs_oracle"] < RMSE_BAR:
        raise RuntimeError(f"K1 per-block disagrees at the protocol shape: {rec}")
    del out, oracle
    key = flash_mod._tile_key(q, k, None, True, causal, None)
    hit = autotune.lookup(key) if key else None
    tiles = autotune.K1_TILES[shapes.kernel_width(q.shape[-1])].index(hit) if hit else 0
    q8, _, rq = quant.block_quant(q, bq)
    k8, _, rk = quant.block_quant(k, bkv)
    ms = time_ms(call, iters=3, warmup=1)
    prepass = time_ms(lambda: (quant.block_quant(q, bq), quant.block_quant(k, bkv)), iters=3, warmup=1)
    with _tiles_forced(tiles):
        k1_ms = time_ms(functools.partial(flash_attention, q8, k8, v, scale_q=rq, scale_k=rk,
                                          is_causal=causal), iters=3, warmup=1)
    del q8, k8, rq, rk
    rec.update({"fp8_block_ms": ms, "fp8_block_tflops": flops / ms / 1e9, "fp8_block_blocks": [bq, bkv],
                "fp8_block_tiles": list(autotune.K1_TILES[shapes.kernel_width(q.shape[-1])][tiles]),
                "fp8_block_prepass_ms": prepass, "fp8_block_k1_ms": k1_ms,
                "fp8_block_prepass_share": prepass / ms})
    return rec


def _graph_equal(fn) -> bool:
    """One call of ``fn`` captured in a CUDA graph and replayed gives the
    eager call's bits."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    graph.replay()
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    del graph
    return equal


def _k4_cache(gen, b, hkv, s_max, d, kind):
    """A K4 cache of random rows: int8 or e4m3 codes, or int4 codes packed
    along the head dim, with token scales, or bf16, fp16 or fp32; and its
    dequantized fp32 rows."""
    kf = _randn((b, hkv, s_max, d), gen, torch.float32)
    vf = _randn((b, hkv, s_max, d), gen, torch.float32)
    if kind in FLOAT_CACHES:
        kc, vc = kf.to(FLOAT_CACHES[kind]), vf.to(FLOAT_CACHES[kind])
        return (kc, vc, None, None), (kc.float(), vc.float())
    if kind == "int4":
        (kc, ks), (vc, vs) = (quant.dynamically_quantize_int4(x, reduction_dim=-1) for x in (kf, vf))
        deq = tuple(quant.dequantize(quant.unpack_int4(c), sc) for c, sc in ((kc, ks), (vc, vs)))
        return (kc, vc, ks, vs), deq
    fn = quant.dynamically_quantize_int8 if kind == "int8" else quant.dynamically_quantize_fp8
    (kc, ks), (vc, vs) = (fn(x, reduction_dim=-1) for x in (kf, vf))
    return (kc, vc, ks, vs), (quant.dequantize(kc, ks), quant.dequantize(vc, vs))


def _cache_kind(t: torch.Tensor, d: int) -> str:
    """The cache type of a K4 cache tensor (int4: a halved minor dim)."""
    if t.shape[-1] * 2 == d:
        return "int4"
    return {torch.int8: "int8", torch.float8_e4m3fn: "e4m3", torch.bfloat16: "bf16",
            torch.float16: "f16", torch.float32: "f32"}[t.dtype]


def _k4_check(label, q, cache, deq, lens, lengths) -> dict:
    """K4 against its plain version and the fp32 oracle; raises where it
    disagrees, is not finite, leaves an empty slot non-zero, or differs
    between two runs."""
    kc, vc, ks, vs = cache
    out = decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
    again = decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
    plain = decode_attention_plain(q, kc, vc, lengths, ks, vs)
    b, hq, d = q.shape
    oracle = torch.zeros((b, hq, d), device="cuda")
    for i, n in enumerate(lens):
        if n:
            oracle[i] = sdpa_reference(q[i : i + 1, :, None, :].float(), deq[0][i : i + 1, :, :n],
                                       deq[1][i : i + 1, :, :n], out_dtype=torch.float32)[0, :, 0, :]
    torch.cuda.synchronize()
    rec = {"cache": _cache_kind(kc, d), "q": str(q.dtype).split(".")[-1], "B": b, "Hq": hq,
           "Hkv": kc.shape[1], "D": d,
           "lengths": list(lens), **decode_vs_plain(out, plain, lens),
           "rmse_vs_oracle": rmse(out, oracle),
           "zero_row_exact": all(bool((out[i] == 0).all()) for i, n in enumerate(lens) if n == 0),
           "bitwise_two_runs": torch.equal(out, again)}
    if (not bool(torch.isfinite(out.float()).all()) or not decode_close(rec)
            or not rec["rmse_vs_oracle"] < RMSE_BAR or not rec["zero_row_exact"]
            or not rec["bitwise_two_runs"]):
        raise RuntimeError(f"K4 disagrees ({label}): {rec}")
    return rec


def phase_k4(gen) -> dict:
    """K4 against its plain version and the fp32 oracle at the 4-slot
    serving shape (int8, bf16, int4 and e4m3 caches), bitwise equal across
    two runs and under graph capture; the core's registers and spills
    (``k4_ptxas``); device time by graph replay with the cache cold in L2
    (``ms``: copies cycled past COLD_BYTES, as K10's), by CUDA events with
    the host's work (``call_ms``), the plain version's, and for the bf16
    cache SDPA over the same rows (``library_ms``); a float32 query over the
    int4 cache (``k4_f32_query``); for the fp16 cache the query's fp16
    conversion timed apart (``query_convert_ms``); then head dims
    72/96/320/512 (``k4_width``; int4 and e4m3 too at 72 and 512), a GQA
    group of 32 (``k4_group``) and the draft's head dim 64 (``k4_draft``)."""
    # The decode-attention core (W, NG, mode 0 K4 / 1 K10 / 2 unscaled, kind
    # 0 int8 / 1 e4m3 / 2 bf16 / 3 int4 by head dim / 4 int4 by token / 5
    # fp16 / 6 fp32, multi 1 in verify mode) and its merge kernel.
    for row in _ptxas("decode_attn_kernel", ("W", "NG", "mode", "kind")) + _ptxas("merge_kernel", ()):
        log("k4_ptxas " + json.dumps(row))
    b, hq, hkv, s_max, d = 4, 32, 8, 2048, 128
    lens = [0, 57, 900, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst = 0.0
    timing = None
    for kind in ("int8", "bf16", "int4", "e4m3", "f16", "f32"):
        q = _randn((b, hq, d), gen)
        cache, deq = _k4_cache(gen, b, hkv, s_max, d, kind)
        rec = _k4_check("4 slots", q, cache, deq, lens, lengths)
        if kind == "int4":
            frec = _k4_check("f32 query", q.float(), cache, deq, lens, lengths)
            log("k4_f32_query " + json.dumps(frec))
            worst = max(worst, frec["max_abs_vs_plain"])
        del deq
        kc, vc, ks, vs = cache
        rec["graph_equal"] = _graph_equal(lambda: decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs))
        if not rec["graph_equal"]:
            raise RuntimeError(f"K4 under graph capture differs from the eager call: {rec}")
        nbytes = sum(t.numel() * t.element_size() for t in cache if t is not None)
        n = max(1, math.ceil(COLD_BYTES / nbytes))
        caches = [cache] + [tuple(None if t is None else t.clone() for t in cache) for _ in range(n - 1)]
        rec["cache_copies"] = n
        rec["ms"] = graph_ms([lambda c=c: decode_attention(q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
                              for c in caches])
        rec["call_ms"] = time_ms(lambda: decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs))
        rec["plain_ms"] = time_ms(lambda: decode_attention_plain(q, kc, vc, lengths, ks, vs), iters=5)
        if kind == "f16":
            # The fp16 products' query conversion (kernel_query), one launch
            # of its own, timed apart.
            rec["query_convert_ms"] = graph_ms(lambda: kernel_query(q, KINDS["f16"]))
        if kind == "bf16":
            # The library call for a bf16 cache: SDPA over the same rows
            # with a length mask (the empty slot 0 left out: SDPA gives NaN
            # for a row that sees no key), timed over the same cold copies.
            mask = (torch.arange(s_max, device="cuda")[None, :] < lengths[1:, None])[:, None, None, :]
            ql = q[1:, :, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ref = sdpa(ql, kc[1:], vc[1:], attn_mask=mask, enable_gqa=True)[:, :, 0]
            out = decode_attention(q, kc, vc, lengths)[1:]
            rec["library_max_abs_vs_k4"] = max_abs(out, ref)
            rec["library_ms"] = graph_ms([lambda c=c: sdpa(ql, c[0][1:], c[1][1:], attn_mask=mask,
                                                           enable_gqa=True) for c in caches])
            del ref, out
        # Bound: the valid K/V rows (codes, and a 4-byte scale a row where
        # quantized), q and out; its few flops a byte bind nothing.
        row_bytes = kc.shape[-1] * kc.element_size() + (4 if ks is not None else 0)
        cache_bytes = sum(lens) * hkv * 2 * row_bytes
        rec["kernel_GBps"] = cache_bytes / rec["ms"] / 1e6
        rec.update(bound(cache_bytes + 2 * b * hq * d * 2))
        log("k4 " + json.dumps(rec))
        worst = max(worst, rec["max_abs_vs_plain"])
        if kind == "int8":
            timing = rec
        del caches, cache
    torch.cuda.empty_cache()
    # Fault 9: every head dim JAX takes (between and above the instantiated
    # widths) and a group of more than 16 query heads a KV head; fault 12:
    # the int4 and e4m3 caches at 72 (rows of 36 and 72 bytes: cp.async)
    # and 512.
    for dw in ANY_WIDTHS:
        hq_w, hkv_w = ((D96_MODEL["num_q_heads"], D96_MODEL["num_kv_heads"]) if dw == 96
                       else (D256_MODEL["num_q_heads"], D256_MODEL["num_kv_heads"]))
        kinds = VERIFY_KINDS if dw in LOWBIT_WIDTHS else ("int8", "bf16")
        worst = max(worst, _k4_width(gen, dw, hq_w, hkv_w, "k4_width", kinds))
    worst = max(worst, _k4_width(gen, 128, 32, 1, "k4_group", ("int8", "bf16", "int4")))
    # The draft's steps in phase_speculative: head dim 64 at Llama-3.2-1B's
    # heads, over the draft's int8 and fp16 caches (and int4).
    worst = max(worst, _k4_width(gen, DRAFT_1B["head_dim"], DRAFT_1B["num_q_heads"], DRAFT_1B["num_kv_heads"],
                                 "k4_draft", ("int8", "int4", "f16")))
    vworst, verify = _k4_verify(gen)
    # The JSON line: the int8 cache. No PyTorch call reads an int8 cache
    # with token-wise scales (the bf16 cache's SDPA time is on its k4 line,
    # the masked SDPA beside verify mode on its k4_verify_time line).
    return {"max_abs_err": max(worst, vworst), "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"], "library_ms": None,
            **verify}


def _verify_mask(lengths: torch.Tensor, t: int, hq: int, s_max: int) -> torch.Tensor:
    """The (B, Hq, T, S) boolean mask of verify mode: candidate i of slot b
    sees the columns below lengths[b] - (T - 1 - i)."""
    lim = lengths[:, None] - (t - 1 - torch.arange(t, device=lengths.device))[None, :]
    mask = torch.arange(s_max, device=lengths.device)[None, None, :] < lim[:, :, None]
    return mask[:, None].expand(-1, hq, -1, -1)


def _verify_check(label: str, rec: dict, out, plain, lens, launched: int) -> dict:
    """A verify-mode call against its plain version (every non-empty slot
    at least T long): one verify launch, finite, the decode bars, exact
    zeros for the empty slot 0.  Raises where it misses."""
    rec.update(decode_vs_plain(out, plain, lens), verify_launches=launched,
               zero_row_exact=bool((out[0] == 0).all()))
    if (launched != 1 or not bool(torch.isfinite(out.float()).all()) or not decode_close(rec)
            or not rec["zero_row_exact"]):
        raise RuntimeError(f"{label} disagrees: {rec}")
    log(f"{label} " + json.dumps(rec))
    return rec


def _verify_timing(label: str, call, plain_call, copies: list, valid_bytes: int, library) -> dict:
    """Device time of a verify-mode call, cold (``profiling.chain_bench``
    over copies of the cache or pool cycled past COLD_BYTES, one CUDA
    graph), its plain version's, the bound (``valid_bytes``), and the
    library call's over the same copies (``library``: None, or a callable
    of one copy)."""
    iters = 8 * len(copies)
    rec = {"copies": len(copies),
           "ms": 1e3 * profiling.chain_bench(call, copies, iters=iters, reps=5),
           "plain_ms": time_ms(lambda: plain_call(*copies[0]), iters=3, warmup=1),
           "library_ms": None, **bound(valid_bytes)}
    if library is not None:
        rec["library_ms"] = 1e3 * profiling.chain_bench(library, copies, iters=iters, reps=5)
    log(f"{label} " + json.dumps(rec))
    return rec


def _k4_verify(gen) -> tuple:
    """K4 in verify mode (ops/decode.py:359-363 of the JAX package): 4 slots
    of 0/57/900/2047 rows, T candidates a head (``VERIFY_T``), GQA groups
    ``VERIFY_G`` over 8 KV heads, every cache kind, against its plain
    version; then at T = 5 over Llama-3-8B's heads the device time, cold,
    by graph replay (int8 and bf16; for bf16 SDPA with the (B, Hq, T, S)
    mask over the same rows, the empty slot left out).  Returns (worst
    error, the JSON line's verify keys)."""
    b, hkv, s_max, d = 4, 8, 2048, 128
    lens = [0, 57, 900, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst = 0.0
    for t in VERIFY_T:
        for g in VERIFY_G:
            for kind in VERIFY_KINDS:
                q = _randn((b, hkv * g, t, d), gen)
                (kc, vc, ks, vs), _ = _k4_cache(gen, b, hkv, s_max, d, kind)
                before = decode_attention.verify_launches
                out = decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
                launched = decode_attention.verify_launches - before
                plain = decode_attention_plain(q, kc, vc, lengths, ks, vs)
                torch.cuda.synchronize()
                rec = _verify_check("k4_verify", {"cache": kind, "T": t, "G": g}, out, plain, lens,
                                    launched)
                worst = max(worst, rec["max_abs_vs_plain"])
                del q, kc, vc, ks, vs, out, plain
    torch.cuda.empty_cache()
    t, hq = VERIFY_TIMED_T, 32
    times = {}
    for kind in ("int8", "bf16"):
        q = _randn((b, hq, t, d), gen)
        cache, _ = _k4_cache(gen, b, hkv, s_max, d, kind)
        nbytes = sum(x.numel() * x.element_size() for x in cache if x is not None)
        copies = [cache] + [tuple(None if x is None else x.clone() for x in cache)
                            for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)) - 1)]
        library = None
        if kind == "bf16":
            mask = _verify_mask(lengths[1:], t, hq, s_max)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ref = sdpa(q[1:], cache[0][1:], cache[1][1:], attn_mask=mask, enable_gqa=True)
            got = decode_attention(q, cache[0], cache[1], lengths)[1:]
            log(f"k4_verify_library max_abs_vs_k4={max_abs(got, ref)}")

            def library(kc, vc, _ks, _vs):
                return sdpa(q[1:], kc[1:], vc[1:], attn_mask=mask, enable_gqa=True)
        row_bytes = cache[0].shape[-1] * cache[0].element_size() + (4 if cache[2] is not None else 0)
        valid = sum(lens) * hkv * 2 * row_bytes + 2 * q.numel() * 2
        times[kind] = _verify_timing(
            f"k4_verify_time cache={kind} T={t} G={hq // hkv}",
            lambda kc, vc, ks, vs: decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs),
            lambda kc, vc, ks, vs: decode_attention_plain(q, kc, vc, lengths, ks, vs),
            copies, valid, library)
        del copies, cache, q
    torch.cuda.empty_cache()
    return worst, {"verify_ms": times["int8"]["ms"], "verify_plain_ms": times["int8"]["plain_ms"],
                   "verify_bound_ms": times["int8"]["bound_ms"],
                   "verify_library_ms": times["bf16"]["library_ms"], "verify_bf16_ms": times["bf16"]["ms"]}


def _k4_width(gen, d: int, hq: int, hkv: int, label: str, kinds=("int8", "bf16")) -> float:
    """K4 at head dim d over caches of ``kinds``, 4 slots of lengths
    0/57/900/2047, against its plain version and the fp32 oracle; device
    time by graph replay."""
    lens = [0, 57, 900, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst = 0.0
    for kind in kinds:
        q = _randn((4, hq, d), gen)
        cache, deq = _k4_cache(gen, 4, hkv, 2048, d, kind)
        rec = _k4_check(label, q, cache, deq, lens, lengths)
        kc, vc, ks, vs = cache
        rec["ms"] = graph_ms(lambda: decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs))
        log(f"{label} " + json.dumps(rec))
        worst = max(worst, rec["max_abs_vs_plain"])
        del cache, deq, kc, vc, ks, vs
    torch.cuda.empty_cache()
    return worst


def phase_k1_residuals(gen) -> dict:
    """K1's (m, l) against their plain version; the output is unchanged."""
    cases = [(1, 57, "bf16", True, 128), (4, 1536, "bf16", True, 128),
             (1, 512, "bf16", False, 128), (1, 512, "head", True, 128),
             (1, 512, "bf16", True, 64), (1, 512, "bf16", True, 256),
             (1, 1536, "head", True, 128)]
    worst = {"m_abs": 0.0, "l_rel": 0.0}
    for b, s, mode, causal, d in cases:
        q = _randn((b, 32, s, d), gen)
        k = _randn((b, 8, s, d), gen)
        v = _randn((b, 8, s, d), gen)
        args, scales = (q, k, v), {}
        if mode == "head":
            q8, sq = quant.quantize_head_wise(q, torch.float8_e4m3fn)
            k8, sk = quant.quantize_head_wise(k, torch.float8_e4m3fn)
            args, scales = (q8, k8, v), {"scale_q": sq, "scale_k": sk}
        out, (m, l) = flash_attention(*args, is_causal=causal, return_residuals=True, **scales)
        bare = flash_attention(*args, is_causal=causal, **scales)
        _, (pm, pl) = flash_attention_plain(*args, is_causal=causal, return_residuals=True, **scales)
        torch.cuda.synchronize()
        rec = {"B": b, "S": s, "D": d, "mode": mode, "causal": causal,
               "m_max_abs_vs_plain": max_abs(m, pm),
               "l_max_rel_vs_plain": float(((l - pl).abs() / pl).max()),
               "out_equal_without_residuals": bool(torch.equal(out, bare))}
        m_bar, l_bar = ((FP8_RESIDUAL_M_ATOL, FP8_RESIDUAL_L_RTOL) if mode == "head"
                        else (RESIDUAL_M_ATOL, RESIDUAL_L_RTOL))
        rec.update(m_bar=m_bar, l_bar=l_bar)
        log("k1_residuals " + json.dumps(rec))
        if (not bool(torch.isfinite(m).all() and torch.isfinite(l).all())
                or not rec["m_max_abs_vs_plain"] <= m_bar
                or not rec["l_max_rel_vs_plain"] <= l_bar
                or not rec["out_equal_without_residuals"]):
            raise RuntimeError(f"K1 residuals disagree: {rec}")
        worst["m_abs"] = max(worst["m_abs"], rec["m_max_abs_vs_plain"])
        worst["l_rel"] = max(worst["l_rel"], rec["l_max_rel_vs_plain"])
        del q, k, v, args, out, bare, m, l, pm, pl
    torch.cuda.empty_cache()
    return worst


def _oracle_grads(q, k, v, do, causal, window=None):
    """(dq, dk, dv) by autograd of the fp32 oracle."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = sdpa_reference(*leaves, is_causal=causal, window=window, out_dtype=torch.float32)
    return torch.autograd.grad(out, leaves, do.float())


def sdpa_bwd_ms(gen, q, k, v, causal: bool, backends, graph: bool = True) -> float:
    """SDPA's backward (dQ, dK and dV in one autograd call) through the
    given back ends, by CUDA-graph replay (or CUDA events): the yardstick of
    K2 and K3, used nowhere in the port."""
    from torch.nn.attention import sdpa_kernel

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(backends):
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])
        do = _randn(tuple(out.shape), gen)

        def fn():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        return graph_ms(fn, reps=5, iters=10) if graph else time_ms(fn, iters=3, warmup=1)


def _k23_case(gen, b, hq, hkv, s, causal, d) -> tuple:
    """One K2/K3 case: (record, inputs) with the errors against the plain
    version and the oracle's autograd, and two runs' bitwise equality."""
    q, k, v = _randn((b, hq, s, d), gen), _randn((b, hkv, s, d), gen), _randn((b, hkv, s, d), gen)
    do = _randn((b, hq, s, d), gen)
    out, (m, l) = flash_attention(q, k, v, is_causal=causal, return_residuals=True)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    again = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal)
    oracle = _oracle_grads(q, k, v, do, causal)
    torch.cuda.synchronize()
    rec = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": causal,
           "bitwise_repeat": all(torch.equal(x, y) for x, y in zip(grads, again))}
    for name, g, p, o in zip(("dq", "dk", "dv"), grads, plain, oracle):
        rec[f"{name}_rel_vs_plain"] = max_rel(g, p)
        rec[f"{name}_rel_vs_oracle"] = max_rel(g, o)
        rec[f"{name}_max_abs_vs_plain"] = max_abs(g, p)
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"K2/K3 gave non-finite {name}: {rec}")
    return rec, (q, k, v, do, out, m, l)


def phase_k23(gen) -> dict:
    """K2 and K3 against their plain version and the fp32 oracle's autograd
    over head dims and GQA groups, bitwise equal across two runs; device
    times at the timed shape; the protocol shape."""
    for row in _ptxas("flash_bwd_dq_kernel|flash_bwd_dkv_kernel"):
        log("k23_ptxas " + json.dumps(row))
    # (B, Hq, Hkv, S, causal, D): Llama-3-8B's heads at D = 128; GQA groups
    # 1, 4 and 8 at the other widths.
    cases = [(b, 32, 8, s, causal, 128) for b in (1, 4) for s in (57, 512, 1536)
             for causal in (True, False)]
    cases += [(1, 32, 8, 512, True, 64), (1, 32, 8, 512, True, 256), (1, 32, 8, 200, False, 256),
              (1, 32, 32, 512, True, 96), (1, 32, 8, 333, False, 96), (1, 16, 8, 512, True, 320),
              (1, 16, 2, 200, False, 320), (1, 16, 8, 256, True, 512), (1, 8, 1, 130, True, 512),
              (1, 64, 8, 300, True, 72)]
    worst = {"dq": 0.0, "dkv": 0.0}
    timing = None
    for b, hq, hkv, s, causal, d in cases:
        rec, (q, k, v, do, out, m, l) = _k23_case(gen, b, hq, hkv, s, causal, d)
        if (b, hq, s, causal, d) in ((1, 32, 1536, True, 128), (4, 32, 1536, True, 128)):
            delta = row_delta(out, do)
            args = (q, k, v, do, m, l, delta)
            # The kernels alone (their per-row statistics packed once, as
            # flash_attention_bwd packs them for both), then each call by
            # events, packing included (the parent's K2/K3 were timed so).
            kw = {"is_causal": causal, "stats": pack_stats(m, l, delta)}
            rec["dq_ms"] = graph_ms(lambda: flash_bwd_dq(*args, **kw))
            rec["dkv_ms"] = graph_ms(lambda: flash_bwd_dkv(*args, **kw))
            rec["dq_call_ms"] = time_ms(lambda: flash_bwd_dq(*args, is_causal=causal))
            rec["dkv_call_ms"] = time_ms(lambda: flash_bwd_dkv(*args, is_causal=causal))
            rec["dq_plain_ms"] = time_ms(lambda: flash_bwd_dq_plain(*args, is_causal=causal), iters=5)
            rec["dkv_plain_ms"] = time_ms(lambda: flash_bwd_dkv_plain(*args, is_causal=causal), iters=5)
            # The fp8 path's whole backward (bf16 K1 recompute, then K2/K3)
            # against its plain counterpart, the oracle recompute VJP.
            rec["fp8_bwd_ms"] = time_ms(lambda: exact_attention_bwd(q, k, v, do, causal, None))
            with config.patch({"kernel.cuda_bwd": False}):
                rec["fp8_bwd_plain_ms"] = time_ms(
                    lambda: exact_attention_bwd(q, k, v, do, causal, None), iters=5)
            # Products per q head: K2 three (S, dP, dS.K), K3 four
            # (S^T, dP^T, P^T.dO, dS^T.Q), each 2*S*S*D flops; half under the mask.
            unit = 2 * b * 32 * s * s * d / (2 if causal else 1)
            rec["dq_tflops"] = 3 * unit / rec["dq_ms"] / 1e9
            rec["dkv_tflops"] = 4 * unit / rec["dkv_ms"] / 1e9
            if b == 1:
                timing = rec
        log("k23 " + json.dumps(rec))
        bad = [key for key, val in rec.items() if "_rel_vs_" in key and not val < GRAD_BAR]
        if bad or not rec["bitwise_repeat"]:
            raise RuntimeError(f"K2/K3 disagree ({bad}): {rec}")
        worst["dq"] = max(worst["dq"], rec["dq_max_abs_vs_plain"])
        worst["dkv"] = max(worst["dkv"], rec["dk_max_abs_vs_plain"], rec["dv_max_abs_vs_plain"])
        del q, k, v, do, out, m, l
    torch.cuda.empty_cache()
    _k23_protocol(gen)
    # Bounds at the timed shape (1, 1536, bf16, causal): each kernel reads q,
    # k, v, dO and the fp32 rows m, l, delta once and writes its gradients;
    # K2 does three products and K3 four, 2 * Hq * S^2 * D / 2 each. The
    # library call (SDPA's whole backward, phase_sdpa_backward) is timed last.
    s, d = 1536, 128
    reads = (32 + 8 + 8 + 32) * s * d * 2 + 3 * 32 * s * 4
    unit = 2 * 32 * s * s * d / 2
    return {
        "dq": {"max_abs_err": worst["dq"], "ms": timing["dq_ms"], "plain_ms": timing["dq_plain_ms"],
               **bound(reads + 32 * s * d * 2, {"bf16": 3 * unit})},
        "dkv": {"max_abs_err": worst["dkv"], "ms": timing["dkv_ms"],
                "plain_ms": timing["dkv_plain_ms"],
                **bound(reads + 2 * 8 * s * d * 2, {"bf16": 4 * unit})},
    }


def phase_sdpa_backward(gen) -> float:
    """SDPA's whole backward (dQ, dK and dV in one call) at K2/K3's timed
    shape (B = 1, 32/8 heads, S = 1536, D = 128, causal, bf16) by CUDA-graph
    replay, each back end alone and the two together, and by CUDA events:
    the library call beside both kernels. It runs after every other phase:
    a failed capture of SDPA's autograd backward (its flash back end's, on
    the H100) can leave PyTorch's default CUDA generator unusable, and
    nothing after it draws from that generator. Returns the graph-replay
    time of the two back ends together (the events' where capture failed)."""
    from torch.nn.attention import SDPBackend

    s, d = 1536, 128
    q, k, v = _randn((1, 32, s, d), gen), _randn((1, 8, s, d), gen), _randn((1, 8, s, d), gen)
    both = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]
    lib = {"call_ms": sdpa_bwd_ms(gen, q, k, v, True, both, graph=False)}
    for name, backends in (("flash", [SDPBackend.FLASH_ATTENTION]),
                           ("cudnn", [SDPBackend.CUDNN_ATTENTION]), ("either", both)):
        try:
            lib[name] = sdpa_bwd_ms(gen, q, k, v, True, backends)
        except RuntimeError as e:  # the back end refuses the shape, or capture fails
            lib[name] = None
            lib[f"{name}_error"] = str(e).splitlines()[0][:160]
    log("k23 library sdpa_bf16_backward_ms=" + json.dumps(lib))
    return lib["either"] if lib["either"] is not None else lib["call_ms"]


def _k23_protocol(gen) -> None:
    """K2 and K3 at the original library's protocol shape (B = 16, H = 16,
    S = 8192, D = 128, causal, bf16) beside SDPA's flash and cuDNN
    backward, by CUDA events. TFLOP/s count the backward's five products
    (2.5x the forward's 4 B H S^2 D, halved under the mask) for all three;
    K2 and K3 run seven between them (the score products twice). The plain
    version would need 17 GB of fp32 scores a call: one batch entry and two
    heads are held against the fp32 oracle's autograd."""
    from torch.nn.attention import SDPBackend

    b, h, s, d = PROTOCOL["B"], PROTOCOL["H"], PROTOCOL["S"], 128
    q, k, v, do = (_randn((b, h, s, d), gen) for _ in range(4))
    out, (m, l) = flash_attention(q, k, v, is_causal=True, return_residuals=True)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=True)
    oracle = _oracle_grads(*(t[:1, :2] for t in (q, k, v, do)), True)
    rec = {"B": b, "H": h, "S": s, "D": d, "causal": True}
    for name, g, o in zip(("dq", "dk", "dv"), grads, oracle):
        rec[f"{name}_rel_vs_oracle"] = max_rel(g[:1, :2], o)
    del grads, oracle
    delta = row_delta(out, do)
    args = (q, k, v, do, m, l, delta)
    kw = {"is_causal": True, "stats": pack_stats(m, l, delta)}
    rec["dq_ms"] = time_ms(lambda: flash_bwd_dq(*args, **kw), iters=3, warmup=1)
    rec["dkv_ms"] = time_ms(lambda: flash_bwd_dkv(*args, **kw), iters=3, warmup=1)
    flops = 5 * 2 * b * h * s * s * d / 2
    rec["k23_ms"] = rec["dq_ms"] + rec["dkv_ms"]
    rec["k23_tflops"] = flops / rec["k23_ms"] / 1e9
    del args, delta, out, m, l
    torch.cuda.empty_cache()
    for name, backend in (("sdpa_flash", SDPBackend.FLASH_ATTENTION),
                          ("sdpa_cudnn", SDPBackend.CUDNN_ATTENTION)):
        try:
            ms = sdpa_bwd_ms(gen, q, k, v, True, [backend], graph=False)
        except RuntimeError as e:  # the back end refuses this shape
            rec[f"{name}_ms"] = rec[f"{name}_tflops"] = None
            rec[f"{name}_refused"] = str(e).splitlines()[0][:120]
            continue
        rec[f"{name}_ms"], rec[f"{name}_tflops"] = ms, flops / ms / 1e9
        torch.cuda.empty_cache()
    log("k23_protocol " + json.dumps(rec))
    if not all(rec[f"{n}_rel_vs_oracle"] < GRAD_BAR for n in ("dq", "dk", "dv")):
        raise RuntimeError(f"K2/K3 disagree at the protocol shape: {rec}")
    del q, k, v, do
    torch.cuda.empty_cache()


#: Every launch count the smoke reads, as (wrapper, attribute).
_COUNTERS = (
    (flash_attention, "launches"), (flash_attention, "window_launches"),
    (flash_attention, "segment_launches"), (flash_attention, "block_mask_launches"),
    (flash_attention, "int8_v_launches"),
    (decode_attention, "launches"), (decode_attention, "verify_launches"),
    (decode_attention, "window_launches"),
    (paged_decode_attention, "launches"), (paged_decode_attention, "verify_launches"),
    (paged_decode_attention, "window_launches"),
    (megastep.fused_decode_layer, "launches"), (megastep.fused_decode_layer, "window_launches"),
    (qmm.quantized_matmul, "launches"), (qmm.quantized_matmul, "splitk_launches"),
    (qmm.quantized_matmul4, "launches"), (qmlp.fused_layer_tail, "launches"),
    (dispatch.sdpa_fallback, "calls"), (quant.block_quant, "launches"),
)


def _reset_counts() -> None:
    for obj, attr in _COUNTERS:
        setattr(obj, attr, 0)


@contextlib.contextmanager
def _uncounted():
    """A check's own runs inside a counted window: every launch count (and
    ``qmm.route_launches``) is as it was before the block."""
    saved = [getattr(obj, attr) for obj, attr in _COUNTERS]
    routes = dict(qmm.route_launches)
    try:
        yield
    finally:
        for (obj, attr), v in zip(_COUNTERS, saved):
            setattr(obj, attr, v)
        qmm.route_launches.update(routes)


def _counts() -> dict:
    return {"k1": flash_attention.launches, "k4": decode_attention.launches,
            "k5": qmm.quantized_matmul.launches, "k6": qmm.quantized_matmul.splitk_launches,
            "k7": qmm.quantized_matmul4.launches, "k8": qmlp.fused_layer_tail.launches,
            "k9": megastep.fused_decode_layer.launches, "k10": paged_decode_attention.launches,
            "k4_verify": decode_attention.verify_launches,
            "k10_verify": paged_decode_attention.verify_launches,
            "k1_window": flash_attention.window_launches, "k4_window": decode_attention.window_launches,
            "k9_window": megastep.fused_decode_layer.window_launches,
            "k10_window": paged_decode_attention.window_launches,
            "block_quant": quant.block_quant.launches,
            "k1_segments": flash_attention.segment_launches,
            "k1_block_mask": flash_attention.block_mask_launches,
            "k1_int8_v": flash_attention.int8_v_launches,
            "sdpa_fallback": dispatch.sdpa_fallback.calls}


def _weight_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_weight_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_weight_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _timed_engine(eng, burst=None) -> dict:
    """Run ``eng`` to completion (decode in bursts of ``burst`` or one step
    a call) with the launch counts reset just before and read just after;
    host time of the prefills (kept with their logits in ``prefills``) and
    of the decode calls (bursts that capture their graph left out of
    ``burst_ms_per_step``)."""
    backend = eng._backend
    timers = {"prefill_s": 0.0, "decode_s": 0.0, "steps": 0, "burst_s": 0.0, "burst_steps": 0,
              "bursts": 0, "captured": 0, "prefill_ms": []}
    prefills = []
    orig = {name: getattr(backend, name) for name in ("prefill_and_write", "decode", "burst")}

    def timed_prefill(prefill_fn, params_, tokens, last_pos, *rest):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = orig["prefill_and_write"](prefill_fn, params_, tokens, last_pos, *rest)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t
        timers["prefill_ms"].append(1e3 * (time.perf_counter() - t))
        prefills.append((tokens.clone(), list(last_pos), logits.clone()))
        return logits

    def timed_decode(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig["decode"](*args)
        torch.cuda.synchronize()
        timers["decode_s"] += time.perf_counter() - t
        timers["steps"] += 1
        return out

    def timed_burst(*args):
        captures = backend.stats["graph_captures"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig["burst"](*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        timers["decode_s"] += sec
        timers["steps"] += args[6]
        if backend.stats["graph_captures"] == captures:
            timers["burst_s"] += sec
            timers["burst_steps"] += args[6]
            timers["bursts"] += 1
        else:
            timers["captured"] += 1
        return out

    backend.prefill_and_write, backend.decode, backend.burst = timed_prefill, timed_decode, timed_burst
    _reset_counts()
    t0 = time.perf_counter()
    try:
        eng.run_to_completion(decode_burst=burst)
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(backend, name, fn)
    wall = time.perf_counter() - t0
    launches = _counts()
    stats = dict(eng.stats)
    return {"launches": launches, "stats": stats, "wall_s": wall, "prefills": prefills,
            "prefill_s": timers["prefill_s"], "decode_s": timers["decode_s"],
            "prefill_ms": timers["prefill_ms"],
            "decode_ms_per_step": 1e3 * timers["decode_s"] / max(1, timers["steps"]),
            "burst_ms_per_step": (1e3 * timers["burst_s"] / timers["burst_steps"]
                                  if timers["burst_steps"] else None),
            "timed_bursts": timers["bursts"], "capturing_bursts": timers["captured"],
            "timed_steps": timers["burst_steps"]}


def _prefill_vs_sdpa(label: str, params, cfg, prefills, plain_flags=None) -> float:
    """Each prefill's last-position logits against the same prompt through
    SDPA attention (with the config's window, and ``plain_flags``), one
    prompt at a time (a batch of long prompts would need tens of GB of fp32
    scores).  Returns the worst relative error; raises past
    PREFILL_REL_BOUND."""
    plain_cfg = dataclasses.replace(cfg, attention_impl="sdpa")
    worst = 0.0
    for tokens, last_pos, logits in prefills:
        for i, pos in enumerate(last_pos):
            with config.patch(plain_flags or {}):
                ref, _ = llama.forward_prefill(params, tokens[i: i + 1, : pos + 1], plain_cfg,
                                               last_pos=torch.tensor([pos], device="cuda"))
            rel = rel_fro(logits[i], ref[0])
            log(f"{label} prefill len={pos + 1} rel_err={rel} "
                f"argmax_agree={bool(logits[i].argmax() == ref[0].argmax())}")
            if not bool(torch.isfinite(logits[i]).all()):
                raise RuntimeError(f"{label}: prefill logits are not finite")
            worst = max(worst, rel)
            del ref
            torch.cuda.empty_cache()
    log(f"{label} prefill worst_rel_err={worst} bound={PREFILL_REL_BOUND}")
    if not worst < PREFILL_REL_BOUND:
        raise RuntimeError(f"{label}: prefill logits off the SDPA run by {worst}")
    return worst


#: Each ``serve`` run's record by label.
SERVE_RECS = {}


#: The caching allocator's counters that ``serve`` reads around a run:
#: device allocations and frees (cudaMalloc / cudaFree), retries after a
#: failed allocation (which free every cached block and synchronize).
ALLOCATOR_COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
                      "num_sync_all_streams")


def _host_stats() -> dict:
    """The allocator's counters, Python's garbage collections and the
    process's CPU seconds, read around a served run."""
    mem = torch.cuda.memory_stats()
    out = {k: mem.get(k, 0) for k in ALLOCATOR_COUNTERS}
    out["gc_collections"] = sum(g["collections"] for g in gc.get_stats())
    out["process_cpu_s"] = time.process_time()
    return out


def _auto_winners() -> dict:
    """The "auto" path winners in the autotune cache, by shape key."""
    return {k: v for k, v in autotune._load_cache().items() if "|path|" in k}


def _auto_path(cfg, tokens) -> "str | None":
    """The cached "auto" winner of a causal prefill of ``tokens`` (B, S)
    under ``cfg``, or None (another scaling method, or no entry)."""
    if cfg.scaling_method != "auto":
        return None
    b, s = tokens.shape
    key = autotune.shape_key("path", b, cfg.num_q_heads, cfg.num_kv_heads, s, s, cfg.head_dim,
                             True, cfg.dtype, tokens.device)
    window = llama.window_of(cfg)
    if window is not None:
        key += f"|w{window[0]}_{window[1]}"
    return autotune._load_cache().get(key)


def serve(label: str, params, prompt_lens, seed: int, plain_flags=None, kv_int4: bool = False,
          cfg=None, check: bool = True):
    """Llama-3-8B (or ``cfg``) serves greedy requests on 4 slots (max_len
    2048, int8 cache, packed int4 with ``kv_int4``) through the Engine, with
    the launch counts reset just before and read just after.  Checks
    completion, K1 and K4 on every layer, SDPA only in the prefills where
    "auto" cached it as the winner, and with ``check`` each prefill's
    last-position logits against the same tree run with plain attention
    (and ``plain_flags``).  The record holds each prefill's ms and the
    host counters read around the run (``_host_stats``).
    Returns (engine, launches, stats)."""
    cfg = llama.llama3_8b() if cfg is None else cfg
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, num_slots=4, max_len=2048, cache_dtype=torch.int8,
                 kv_int4=kv_int4, device="cuda")
    rng = np.random.default_rng(seed)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   max_new_tokens=int(rng.integers(16, 33)))
        for n in prompt_lens
    ]
    before = _host_stats()
    run = _timed_engine(eng)
    after = _host_stats()
    launches, stats = run["launches"], run["stats"]
    decode_tokens = stats["generated_tokens"] - len(reqs)
    rec = {
        "stats": stats, "launches": launches, "wall_s": run["wall_s"],
        "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
        "prefill_ms": run["prefill_ms"],
        "host_stats": {k: after[k] - before[k] for k in before},
        "decode_tok_s": decode_tokens / run["decode_s"],
        "decode_ms_per_step": run["decode_ms_per_step"],
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    SERVE_RECS[label] = rec
    log(f"{label} " + json.dumps(rec))

    for r in reqs:
        if not r.done or len(r.output) != r.max_new_tokens:
            raise RuntimeError(f"{label}: request {r.id} ended with {len(r.output)} of {r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise RuntimeError(f"{label}: request {r.id} produced out-of-vocabulary tokens")
    L = cfg.num_layers
    # "auto" runs SDPA exactly in the prefills whose cached winner is "sdpa"
    # and K1 in every other one.
    sdpa = L * sum(_auto_path(cfg, tokens) == "sdpa" for tokens, _, _ in run["prefills"])
    if launches["k1"] + sdpa < L * stats["prefill_forwards"]:
        raise RuntimeError(f"{label}: K1 ran {launches['k1']} times for {stats['prefill_forwards']} prefills")
    if launches["k4"] < L * stats["decode_steps"]:
        raise RuntimeError(f"{label}: K4 ran {launches['k4']} times for {stats['decode_steps']} decode steps")
    if launches["sdpa_fallback"] != sdpa:
        raise RuntimeError(f"{label}: SDPA ran {launches['sdpa_fallback']} times where the cache "
                           f"routes {sdpa} attention calls to it")
    if check:
        _prefill_vs_sdpa(label, params, cfg, run["prefills"], plain_flags)
    return eng, launches, stats


def phase_engine():
    """Llama-3-8B, full width and depth, random bf16 weights, 6 requests."""
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator("cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    log(f"engine init_params_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={torch.cuda.memory_allocated() / 1e9:.3f}")
    _, launches, _ = serve("engine", params, SERVE_PROMPTS, seed=0)
    return launches, params


def phase_engine_burst(params) -> dict:
    """The engine phase's bf16 tree and prompts on 4 slots, decoded in
    CUDA-graph bursts (``run_to_completion(decode_burst=16)``), 64 new
    tokens a request: ms a burst step (bursts that captured their graph
    left out), K4 once a layer a step."""
    cfg = llama.llama3_8b()
    eng = Engine(params, cfg, num_slots=4, max_len=2048, cache_dtype=torch.int8, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=ENGINE_BURST["new"])
            for n in SERVE_PROMPTS]
    run = _timed_engine(eng, burst=ENGINE_BURST["burst"])
    launches, stats = run["launches"], run["stats"]
    rec = {"stats": stats, "backend": dict(eng._backend.stats), "launches": launches,
           "timed_bursts": run["timed_bursts"], "capturing_bursts": run["capturing_bursts"],
           "timed_steps": run["timed_steps"], "burst_ms_per_step": run["burst_ms_per_step"]}
    log("engine_burst " + json.dumps(rec))
    for r in reqs:
        if not r.done or len(r.output) != ENGINE_BURST["new"]:
            raise RuntimeError(f"engine_burst: request {r.id} ended with {len(r.output)} tokens")
    if launches["k4"] < cfg.num_layers * stats["decode_steps"] or run["timed_bursts"] == 0:
        raise RuntimeError(f"engine_burst: K4 ran {launches['k4']} times for {stats['decode_steps']} steps")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _decode_vs_unfused(label: str, eng, tree, seed: int) -> float:
    """One decode step of all 4 slots through K8 against the unfused step
    (``kernel.qmlp = False``) on the same cache state: prefill 4 prompts,
    run the unfused step, restore the lengths (its K/V writes are
    rewritten by the next step), run the K8 step.  Returns the worst
    relative error."""
    cfg = llama.llama3_8b()
    backend = eng._backend
    rng = np.random.default_rng(seed)
    lens = [100, 37, 128, 64]
    tokens = torch.zeros((4, 128), dtype=torch.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
    slots = [0, 1, 2, 3]
    backend.prefill_and_write(eng._prefill_fn, tree, tokens.cuda(), [n - 1 for n in lens],
                              slots, lens, 128)
    saved = [cache.lengths.clone() for cache in backend.caches]
    cur = rng.integers(0, cfg.vocab_size, 4)
    mask = np.ones(4, bool)
    with config.patch({"kernel.qmlp": False}), _uncaptured():
        before = qmlp.fused_layer_tail.launches
        ref = backend.decode(tree, cur, mask, slots)
        if qmlp.fused_layer_tail.launches != before:
            raise RuntimeError(f"{label}: the unfused step ran K8")
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    before = qmlp.fused_layer_tail.launches
    got = backend.decode(tree, cur, mask, slots)
    torch.cuda.synchronize()
    tails = qmlp.fused_layer_tail.launches - before
    rel = (torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1))
    agree = (got.argmax(-1) == ref.argmax(-1)).tolist()
    log(f"{label} decode_vs_unfused k8_calls={tails} rel_err={rel.tolist()} "
        f"argmax_agree={agree} bound={DECODE_K8_REL_BOUND}")
    for slot in slots:
        backend.release(slot)
    if tails != cfg.num_layers:
        raise RuntimeError(f"{label}: the decode step ran K8 {tails} times for {cfg.num_layers} layers")
    if not bool(torch.isfinite(got).all()) or not float(rel.max()) < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: decode logits through K8 off by {rel.tolist()}")
    return float(rel.max())


def _slots_k4_vs_plain(label: str, eng, tree, seed: int, cfg=None, lens=(100, 37, 128, 64)) -> None:
    """One decode step of all 4 slots through K4 against the same step with
    K4's plain version on the same cache (the lengths restored between: the
    step rewrites the same rows), after a whole-prompt prefill of 4
    prompts of ``lens`` tokens (Llama-3-8B's unless ``cfg``)."""
    cfg = llama.llama3_8b() if cfg is None else cfg
    backend = eng._backend
    rng = np.random.default_rng(seed)
    lens = list(lens)
    width = shapes.round_up(max(lens), 128)
    tokens = torch.zeros((4, width), dtype=torch.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
    slots = [0, 1, 2, 3]
    backend.prefill_and_write(eng._prefill_fn, tree, tokens.cuda(), [n - 1 for n in lens],
                              slots, lens, width)
    saved = [cache.lengths.clone() for cache in backend.caches]
    cur = rng.integers(0, cfg.vocab_size, 4)
    mask = np.ones(4, bool)

    kernel = backends.decode_attention
    backends.decode_attention = plain_k4_call
    try:
        before = decode_attention.launches
        with _uncaptured():
            ref = backend.decode(tree, cur, mask, slots)
        if decode_attention.launches != before:
            raise RuntimeError(f"{label}: the plain step launched K4")
    finally:
        backends.decode_attention = kernel
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    before = decode_attention.launches
    got = backend.decode(tree, cur, mask, slots)
    torch.cuda.synchronize()
    k4 = decode_attention.launches - before
    rel = torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    agree = (got.argmax(-1) == ref.argmax(-1)).tolist()
    log(f"{label} k4_vs_plain k4_calls={k4} rel_err={rel.tolist()} argmax_agree={agree} "
        f"bound={DECODE_K8_REL_BOUND}")
    for slot in slots:
        backend.release(slot)
    if k4 != cfg.num_layers:
        raise RuntimeError(f"{label}: the step ran K4 {k4} times for {cfg.num_layers} layers")
    if not bool(torch.isfinite(got).all()) or not float(rel.max()) < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: the K4 step is off its plain step by {rel.tolist()}")


def phase_serve_lowbit(params) -> dict:
    """Fault 12 end to end on Llama-3-8B (the bf16 tree): the slots backend
    with an int4 cache (``serve_kv_int4``: prefill logits against plain
    attention, one decode step through K4 against its plain version), then
    the paged backend with int4 and with e4m3 pages (``serve_paged_int4``,
    ``serve_paged_e4m3``: chunked prefill, a prefix hit, graph bursts, the
    checks of the prefix-caching point at LOWBIT_PAGED's size).  Returns the
    launches of the three runs."""
    eng, launches, _ = serve("serve_kv_int4", params, SERVE_PROMPTS_INT4, seed=5, kv_int4=True)
    if eng.caches[0].k.shape[-1] * 2 != llama.llama3_8b().head_dim:
        raise RuntimeError("serve_kv_int4: the cache is not packed int4")
    _slots_k4_vs_plain("serve_kv_int4", eng, params, seed=6)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    total = dict(launches)
    for label, dtype, int4 in (("serve_paged_int4", torch.int8, True),
                               ("serve_paged_e4m3", torch.float8_e4m3fn, False)):
        got = _serve_paged(label, params, LOWBIT_PAGED, dtype, int4, plain_flags={})
        for k, v in got.items():
            total[k] += v
    return total


class _SpecRecorder:
    """Wraps an engine's speculative round and its backend's ``verify``:
    each round's time (synchronised), the argmax of its verify logits and
    the tokens each slot emitted in it.  With ``check_steps`` the verify
    logits of the first round with ``full`` slots active (the 4 slots of
    (a); 4 of (d)'s 16, whose requests prefill a chunk a step) are also held
    against single decode steps through the attention's plain version
    (``_verify_vs_steps``); that round is left out of the times."""

    def __init__(self, label: str, eng, check_steps: bool, full: int):
        self.label, self.eng, self.rounds, self.step_rel = label, eng, [], None
        self.check_steps, self.full = check_steps, full
        self.orig_verify, self.orig_round = eng._backend.verify, eng._speculative_round
        eng._backend.verify, eng._speculative_round = self._verify, self._round

    def _verify(self, params, cand, positions, active):
        logits = self.orig_verify(params, cand, positions, active)
        self.rounds[-1]["argmax"] = logits.argmax(-1).cpu().numpy()
        if self.check_steps and self.step_rel is None and int(np.sum(active)) >= self.full:
            self.step_rel = _verify_vs_steps(self.label, self.eng, params, cand, positions, active, logits)
            self.rounds[-1]["checked"] = True
        return logits

    def _round(self):
        before = {s: (r, len(r.output)) for s, r in self.eng.active.items()}
        self.rounds.append({})
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.orig_round()
        torch.cuda.synchronize()
        rd = self.rounds[-1]
        rd["s"] = time.perf_counter() - t
        rd["emitted"] = {s: r.output[n0:] for s, (r, n0) in before.items()}
        return out

    def restore(self) -> None:
        del self.eng._backend.verify, self.eng._speculative_round

    def summary(self) -> dict:
        """Checks every emitted token against its round's verify argmax
        (raises where one differs) and returns the rounds' times."""
        if self.check_steps and self.step_rel is None:
            raise RuntimeError(f"{self.label}: no round had {self.full} slots active to check")
        for i, rd in enumerate(self.rounds):
            for slot, emitted in rd["emitted"].items():
                if not emitted or emitted != rd["argmax"][slot, : len(emitted)].tolist():
                    raise RuntimeError(f"{self.label}: round {i}, slot {slot} emitted {emitted}, "
                                       f"not the verify argmax {rd['argmax'][slot].tolist()}")
        timed = [rd for rd in self.rounds if not rd.get("checked")]
        secs = sum(rd["s"] for rd in timed)
        toks = sum(len(e) for rd in timed for e in rd["emitted"].values())
        return {"rounds_timed": len(timed), "ms_per_round": 1e3 * secs / max(1, len(timed)),
                "decode_tok_s": toks / secs if secs else None,
                "tokens_per_round": toks / max(1, len(timed)),
                "verify_vs_steps_rel_err": self.step_rel}


def _verify_vs_steps(label: str, eng, params, cand, positions, active, vlogits) -> float:
    """The verify logits of every active slot at each position t against
    one decode step at that position through the attention's plain version
    (K4's or K10's), on the cache the verify pass wrote (each step rewrites
    its own row); the lengths are put back after.  Raises past the 5% bar
    of the K8, K9 and K10 steps; returns the worst relative error."""
    backend = eng._backend
    slots = np.flatnonzero(active)
    paged = backend.name == "paged"
    attr, plain = (("paged_decode_attention", plain_k10_call) if paged
                   else ("decode_attention", plain_k4_call))

    def set_lengths(n):
        if paged:
            backend.alloc.lengths[slots] = n
        else:
            for cache in backend.caches:
                cache.lengths[torch.as_tensor(slots, device="cuda")] = torch.as_tensor(
                    n, dtype=torch.int32, device="cuda")

    kernel = getattr(backends, attr)
    worst = 0.0
    rels = []
    for t in range(cand.shape[1]):
        set_lengths(positions[slots] + t)
        setattr(backends, attr, plain)
        try:
            with _uncaptured():
                step = backend.decode(params, cand[:, t], active)
        finally:
            setattr(backends, attr, kernel)
        ref = vlogits[slots, t]
        rel = torch.linalg.vector_norm(step[slots] - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
        rels.append(rel.tolist())
        worst = max(worst, float(rel.max()))
        if not bool(torch.isfinite(ref).all()):
            raise RuntimeError(f"{label}: verify logits are not finite")
    set_lengths(positions[slots] if paged else positions[slots] + cand.shape[1])
    log(f"{label} verify_vs_steps rel_err={rels} bound={DECODE_K8_REL_BOUND}")
    if not worst < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: verify logits off single steps by {worst} relative")
    return worst


def _spec_prompts(cfg, lens, seed: int, shared: int = 0) -> list:
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, shared).tolist()
    return [head + rng.integers(0, cfg.vocab_size, n - shared).tolist() for n in lens]


def _spec_run(label: str, tree, cfg, prompts, new: int, engine_kw: dict, draft, check_steps: bool) -> dict:
    """Serve ``prompts`` greedily (``new`` tokens each) on an engine of
    ``engine_kw`` with the draft ``draft`` (or none), the launch counts
    reset just before and read just after.  With a draft: rounds timed and
    checked by ``_SpecRecorder``; without: the single-step path's decode
    steps timed.  Checks every request's length.  Returns the record."""
    spec = {} if draft is None else {"draft": draft, "spec_tokens": SPEC["gamma"]}
    eng = Engine(tree, cfg, device="cuda", **engine_kw, **spec)
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    rec_spec = None if draft is None else _SpecRecorder(label, eng, check_steps,
                                                         min(SPEC["slots"], len(reqs)))
    backend = eng._backend
    timer = {"s": 0.0}
    orig_decode = backend.decode

    def timed_decode(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_decode(*args)
        torch.cuda.synchronize()
        timer["s"] += time.perf_counter() - t
        return out

    backend.decode = timed_decode
    _reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    del backend.decode
    stats = dict(eng.stats)
    rec = {"stats": stats, "launches": launches, "wall_s": wall}
    if rec_spec is not None:
        rec_spec.restore()
        rec.update(rec_spec.summary())
        rec["acceptance"] = stats["spec_accepted"] / max(1, stats["spec_proposed"])
    else:
        rec["decode_ms_per_step"] = 1e3 * timer["s"] / max(1, stats["decode_steps"])
        rec["decode_tok_s"] = (stats["generated_tokens"] - len(reqs)) / timer["s"] if timer["s"] else None
    for r in reqs:
        if not r.done or len(r.output) != new:
            raise RuntimeError(f"{label}: request {r.id} ended with {len(r.output)} of {new} tokens")
    if backend.name == "paged":
        pool = backend.alloc
        rec["pages_in_use_after"] = pool.num_pages - pool.free_pages - pool.evictable_pages
        if rec["pages_in_use_after"] != 0:
            raise RuntimeError(f"{label}: {rec['pages_in_use_after']} pages in use after the last release")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_speculative(params) -> dict:
    """Speculative decoding end to end on Llama-3-8B (the bf16 tree, and
    its int8 fused tree on the paged backend) with a draft at
    Llama-3.2-1B's widths (``DRAFT_1B``), greedy, spec_tokens = 4:
    (a) the slots backend, int8 cache, the engine phase's 4 slots and 6
    prompts, 64 new tokens: K1, K4 verify (T = 5), K4 T = 1 at D = 64 for
    the draft; (b) the target as its own draft, 2 requests; (c) (a) with
    ``kv_int4`` and with a float16 cache, 2 requests each; (d) the int8
    fused tree on the paged backend at serve_paged_prefix_16's geometry,
    33 new tokens: K10 verify, K5, K6 and K8 at 80 rows; (e) (d)'s tree as
    its own draft, 2 requests: rounds with accepted proposals over K10.
    Each run beside the same engine without a draft (its single-step
    path).  Checks: every request's length, every emitted token the argmax
    of its round's verify logits, (a) and (d)'s first-round verify logits
    within 5% of single steps through the plain attention, (d) and (e)'s
    pages all released, (e) accepting proposals, and verify launches of K4
    and K10.  Returns the launches of the draft runs."""
    t_phase = time.perf_counter()
    cfg = llama.llama3_8b()
    dcfg = llama.LlamaConfig(**DRAFT_1B)
    draft = llama.init_params(torch.Generator("cuda").manual_seed(1), dcfg, "cuda")
    slots_kw = {"num_slots": SPEC["slots"], "max_len": SPEC["max_len"], "cache_dtype": torch.int8}
    prompts = _spec_prompts(cfg, SERVE_PROMPTS, seed=0)
    few = prompts[: SPEC["few"]]
    runs = [("spec_slots", params, prompts, slots_kw, (draft, dcfg), True),
            ("spec_self_draft", params, few, slots_kw, (params, cfg), False),
            ("spec_kv_int4", params, few, dict(slots_kw, kv_int4=True), (draft, dcfg), False),
            ("spec_f16_cache", params, few, dict(slots_kw, cache_dtype=torch.float16), (draft, dcfg), False)]
    total = {}
    for label, tree, ps_, kw, drf, check in runs:
        base = _spec_run(label + "_base", tree, cfg, ps_, SPEC["new"], kw, None, False)
        got = _spec_run(label, tree, cfg, ps_, SPEC["new"], kw, drf, check)
        got["no_draft"] = {k: base[k] for k in ("decode_ms_per_step", "decode_tok_s", "wall_s")}
        log(f"{label} " + json.dumps(got))
        if got["launches"]["k4_verify"] < cfg.num_layers * got["stats"]["spec_rounds"]:
            raise RuntimeError(f"{label}: K4 verify ran {got['launches']['k4_verify']} times")
        for k, v in got["launches"].items():
            total[k] = total.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    tree = quantized.fuse_projections(quantized.quantize_params(params))
    shape = SPEC_PAGED
    paged_kw = {"num_slots": shape["slots"], "max_len": shape["max_len"], "cache_dtype": torch.int8,
                "cache_backend": "paged", "page_size": shape["page_size"], "num_pages": shape["num_pages"],
                "prefill_chunk": shape["chunk"], "prefix_cache": True}
    pprompts = _spec_prompts(cfg, [shape["prompt"]] * shape["slots"], seed=16, shared=shape["shared"])
    base = _spec_run("spec_paged_base", tree, cfg, pprompts, shape["new"], paged_kw, None, False)
    got = _spec_run("spec_paged", tree, cfg, pprompts, shape["new"], paged_kw, (draft, dcfg), True)
    got["no_draft"] = {k: base[k] for k in ("decode_ms_per_step", "decode_tok_s", "wall_s")}
    log("spec_paged " + json.dumps(got))
    lp = got["launches"]
    if lp["k10_verify"] < cfg.num_layers * got["stats"]["spec_rounds"] or not (lp["k8"] and lp["k5"] + lp["k6"]):
        raise RuntimeError(f"spec_paged: verify did not run K10, K5/K6 and K8: {lp}")
    for k, v in lp.items():
        total[k] = total.get(k, 0) + v
    # (e) The int8 tree as its own draft on the paged backend, 2 requests:
    # rounds with accepted proposals, which the pages roll back past.
    few = pprompts[: SPEC["few"]]
    base = _spec_run("spec_paged_self_draft_base", tree, cfg, few, shape["new"], paged_kw, None, False)
    got = _spec_run("spec_paged_self_draft", tree, cfg, few, shape["new"], paged_kw, (tree, cfg), False)
    got["no_draft"] = {k: base[k] for k in ("decode_ms_per_step", "decode_tok_s", "wall_s")}
    log("spec_paged_self_draft " + json.dumps(got))
    lp = got["launches"]
    if lp["k10_verify"] < cfg.num_layers * got["stats"]["spec_rounds"] or not got["stats"]["spec_accepted"]:
        raise RuntimeError(f"spec_paged_self_draft: no accepted round over K10: {got['stats']}, {lp}")
    for k, v in lp.items():
        total[k] = total.get(k, 0) + v
    del tree, draft
    gc.collect()
    torch.cuda.empty_cache()
    log(f"spec_phase wall_s={time.perf_counter() - t_phase:.1f}")
    return total


def phase_quant_serving(params, int4: bool) -> dict:
    """The bf16 weights quantized (int8 or int4) and fused, served through
    K1, K4, K5/K6 (or K7) and K8; launches checked, prefill logits against
    the plain run of the same tree, one decode step against the unfused
    step.  The tree is freed before returning."""
    label = "serve_int4" if int4 else "serve_int8"
    cfg = llama.llama3_8b()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    quant_fn = quantized.quantize_params_int4 if int4 else quantized.quantize_params
    tree = quantized.fuse_projections(quant_fn(params))
    torch.cuda.synchronize()
    log(f"{label} quantize_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={_weight_bytes(tree) / 1e9:.3f}")
    eng, launches, stats = serve(
        label, tree, SERVE_PROMPTS_INT4 if int4 else SERVE_PROMPTS, seed=2 if int4 else 1,
        plain_flags={"kernel.qmm": False, "kernel.qmlp": False},
    )
    L = cfg.num_layers
    if launches["k8"] < L * stats["decode_steps"]:
        raise RuntimeError(f"{label}: K8 ran {launches['k8']} times for {stats['decode_steps']} decode steps")
    # int8: K5 and K6 (the split-K rule picks per product); int4: K7, and
    # the int8 LM head through K5 or K6.
    ran = [launches["k7"], launches["k5"] + launches["k6"]] if int4 else [launches["k5"], launches["k6"]]
    if not all(ran):
        raise RuntimeError(f"{label}: a quantized-product kernel never ran: {launches}")
    _decode_vs_unfused(label, eng, tree, seed=3)
    del eng
    gc.collect()
    _quant_prefill(label, tree)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _quant_prefill(label: str, tree) -> dict:
    """One prefill forward of QUANT_PREFILL["tokens"] tokens (batch 1)
    through a fused quantized Llama-3-8B tree: device time by CUDA events
    over QUANT_PREFILL["reps"] forwards after a warm-up.  Checks that each
    forward ran its four products a layer (w_qkv, wo, w_gate_up, w_down)
    at that many rows through K5 (int8) or K7 (int4), and nothing else of
    its kind but the LM head's product at the last position."""
    cfg = llama.llama3_8b()
    n = QUANT_PREFILL["tokens"]
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
    last = torch.tensor([n - 1], device="cuda")
    seen = []
    orig = quantized.matmul

    def recording(x, w, **kw):
        if quantized.is_quantized(w) or quantized.is_quantized4(w):
            seen.append(("k7" if quantized.is_quantized4(w) else "k5", x.reshape(-1, x.shape[-1]).shape[0]))
        return orig(x, w, **kw)

    def forward():
        return llama.forward_prefill(tree, tokens, cfg, last_pos=last)[0]

    logits = forward()  # warm-up
    torch.cuda.synchronize()
    quantized.matmul = recording
    try:
        _reset_counts()
        routes = dict(getattr(qmm, "route_launches", {}))
        logits = forward()
        torch.cuda.synchronize()
        launches = _counts()
    finally:
        quantized.matmul = orig
    rec = {"tokens": n, "layers": cfg.num_layers, "launches": launches,
           "products_at_rows": sum(1 for _, m in seen if m == n),
           "products": {f"{key}@{m}": sum(1 for s in seen if s == (key, m)) for key, m in sorted(set(seen))}}
    if routes:
        rec["wgmma_launches"] = qmm.route_launches["wgmma"] - routes["wgmma"]
    rec["ms"] = time_ms(forward, iters=QUANT_PREFILL["reps"], warmup=1)
    rec["tok_s"] = n / rec["ms"] * 1e3
    log(f"quant_prefill {label} " + json.dumps(rec))
    if logits.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"quant_prefill {label}: logits {tuple(logits.shape)} not finite")
    want = 4 * cfg.num_layers
    kinds = {key for key, m in seen if m == n}
    kind = kinds.pop() if len(kinds) == 1 else None
    others = sum(1 for key, m in seen if key == kind and m != n)
    if rec["products_at_rows"] != want or kind is None or not 0 <= launches[kind] - want <= others:
        raise RuntimeError(f"quant_prefill {label}: {rec['products_at_rows']} products at {n} rows, "
                           f"launches {launches}; want {want} through one kernel")
    if routes and rec["wgmma_launches"] < want:
        raise RuntimeError(f"quant_prefill {label}: {rec['wgmma_launches']} wgmma launches for {want} products")
    return rec


def _qmat_random(k: int, n: int, gen, int4: bool):
    w = _randn((k, n), gen, torch.float32) / math.sqrt(k)
    return quantized.quantize_matrix_int4(w) if int4 else quantized.quantize_matrix(w)


def _cold_copies(w: dict, m: int) -> list:
    """``w`` and clones of it, enough to exceed COLD_BYTES at decode rows."""
    n = max(1, math.ceil(COLD_BYTES / _weight_bytes(w))) if m < QMM_ROWS[-1] else 1
    return [w] + [{k: t.clone() for k, t in w.items()} for _ in range(n - 1)]


def _int8pack_mm(x, copies: list, w: dict) -> dict:
    """``torch._weight_int8pack_mm`` (x times int8 W^T (N, K) with a scale
    an output column, in x's type), where the card's torch runs it on CUDA:
    the library call computing K5's and K6's function (its scales rounded
    to bf16), timed over the same cold weight copies, never used by the
    port."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return {"available": False, "reason": "this torch has no _weight_int8pack_mm"}
    wts = [(c["q"].t().contiguous(), c["s"].reshape(-1).to(x.dtype)) for c in copies]
    try:
        out = fn(x, *wts[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as err:
        return {"available": False, "reason": str(err).strip().splitlines()[0][:200]}
    rec = {"available": True, "rel_vs_plain": max_rel(out, qmm.quantized_matmul_plain(x, w["q"], w["s"])),
           "ms": graph_ms([lambda t=t: fn(x, *t) for t in wts])}
    del wts, out
    return rec


def _int4pack_mm(x, copies: list, w: dict) -> dict:
    """``torch._weight_int4pack_mm`` (x times W^T (N, K) of unsigned nibbles
    q with groups of 128 along K, each weight (q - 8) * scale + zero in
    bf16), where the card's torch runs it on CUDA: with q = code + 8 and
    zero 0 it computes K7's function (its scales rounded to bf16), timed
    over the same cold weight copies, never used by the port.  The nibbles
    are packed for it before timing, two a byte along K (N, K/2)."""
    fn = getattr(torch, "_weight_int4pack_mm", None)
    pack = getattr(torch, "_convert_weight_to_int4pack", None)
    if fn is None or pack is None:
        return {"available": False, "reason": "this torch has no _weight_int4pack_mm"}
    group, inner = 128, 8  # K7's groups; K-tiles of 16 a pack (K = 4096)

    def packed(c):
        codes = (qmm.unpack_int4(c["q4"]) + 8).t().contiguous()  # (N, K) in 0..15
        wp = pack((codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8), inner)
        s = c["s"].to(torch.bfloat16)
        sz = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()  # (K/128, N, 2)
        return wp, group, sz

    try:
        wts = [packed(c) for c in copies]
        out = fn(x, *wts[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as err:
        return {"available": False, "reason": str(err).strip().splitlines()[0][:200]}
    rec = {"available": True, "rel_vs_plain": max_rel(out, qmm.quantized_matmul4_plain(x, w["q4"], w["s"])),
           "ms": graph_ms([lambda t=t: fn(x, *t) for t in wts])}
    del wts, out
    return rec


def _qmm_ptxas() -> list:
    """Registers and spills of each instantiation of the K5/K6/K7 kernel
    (csrc/qgemm.cu: width W, int4, whole tiles)
    and of the fp32 rows' kernel, and whether ptxas serialised its wgmma
    (C7512)."""
    log_lines = _native.build_info()["log"].splitlines()
    rows, cur = [], None
    for line in log_lines:
        m = re.search(r"Function properties for (\S*?qgemm_wgmma_kernelILi(\d+)ELb(\d)ELb(\d)E\S*)", line)
        f = re.search(r"Function properties for (\S*?qgemm_f32_kernelILb(\d)E\S*)", line)
        if m:
            cur = {"kernel": "qgemm_wgmma", "W": int(m.group(2)), "int4": m.group(3) == "1",
                   "whole": m.group(4) == "1", "symbol": m.group(1)}
            continue
        if f:
            cur = {"kernel": "qgemm_f32", "int4": f.group(2) == "1", "symbol": f.group(1)}
            continue
        if cur is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if sp:
            cur["spill_stores"], cur["spill_loads"] = int(sp.group(1)), int(sp.group(2))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            cur["registers"] = int(r.group(1))
            sym = cur.pop("symbol")
            cur["wgmma_serialized"] = any("C7512" in x and sym in x for x in log_lines)
            rows.append(cur)
            cur = None
    return rows


def _qmm_f32_checks(gen) -> None:
    """Fault 10: float32 rows through K5, K6 and K7 on the card, float32
    out, against their plain versions within QMM_F32_REL, at wo's shape."""
    k = n = 4096
    w8, w4 = _qmat_random(k, n, gen, int4=False), _qmat_random(k, n, gen, int4=True)
    for m in (4, 37):
        x = _randn((m, k), gen, torch.float32)
        cases = {
            "k5": (lambda: qmm.quantized_matmul(x, w8["q"], w8["s"], n_streams=1),
                   lambda: qmm.quantized_matmul_plain(x, w8["q"], w8["s"])),
            "k6": (lambda: qmm.quantized_matmul(x, w8["q"], w8["s"], n_streams=4),
                   lambda: qmm.quantized_matmul_plain(x, w8["q"], w8["s"], 4)),
            "k7": (lambda: qmm.quantized_matmul4(x, w4["q4"], w4["s"]),
                   lambda: qmm.quantized_matmul4_plain(x, w4["q4"], w4["s"])),
        }
        for key, (kern, plain) in cases.items():
            before = qmm.route_launches["f32"]
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            rec = {"kernel": key, "M": m, "K": k, "N": n, "dtype": str(out.dtype),
                   "route_f32": qmm.route_launches["f32"] - before,
                   "rel_vs_plain": max_rel(out, ref), "bar": QMM_F32_REL}
            log("qmm_f32 " + json.dumps(rec))
            if (out.dtype != torch.float32 or rec["route_f32"] != 1 or not bool(torch.isfinite(out).all())
                    or not rec["rel_vs_plain"] <= QMM_F32_REL):
                raise RuntimeError(f"{key} over float32 rows: {rec}")


def _qmm_bytes(k: int, n: int, m: int, int4: bool) -> int:
    """Bytes a product must move: the codes and scales, x and out (bf16)."""
    wbytes = k * n // 2 + (k // 128) * n * 4 if int4 else k * n + n * 4
    return wbytes + (m * k + m * n) * 2


def phase_qmm(gen) -> dict:
    """K5, K6 and K7 against their plain versions at Llama-3-8B's shapes,
    each with its bound, beside (at 1536 rows) a bf16 ``torch.matmul`` of
    the same shape (``bf16_gemm_ms``, context for what the card gives a
    bf16 product, not a port) and the library calls where the card's torch
    runs them (K6 at wo, w_qkv and w_down, M = 4 and 64); the routes (all
    three on the register-A wgmma kernel), two runs and a graph replay held
    bitwise equal; then float32 rows (fault 10)."""
    ptx = _qmm_ptxas()
    for rec in ptx:
        log("qmm_ptxas " + json.dumps(rec))
    built = _native.build_info()["seconds"] is not None  # else no compiler output to read
    if built and len([r for r in ptx if r["kernel"] == "qgemm_wgmma"]) != 12:
        raise RuntimeError(f"expected 12 instantiations of the K5/K6/K7 kernel, found {len(ptx)}")
    cfg = llama.llama3_8b()
    e, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = [("w_qkv", e, cfg.q_dim + 2 * cfg.kv_dim), ("wo", cfg.q_dim, e),
              ("w_gate_up", e, 2 * inter), ("w_down", inter, e), ("lm_head", e, cfg.vocab_size)]
    worst = {"k5": 0.0, "k6": 0.0, "k7": 0.0}
    timing = {}
    for name, k, n in shapes:
        w8 = _qmat_random(k, n, gen, int4=False)
        w4 = _qmat_random(k, n, gen, int4=True)
        for m in QMM_ROWS:
            x = _randn((m, k), gen)
            auto = qmm.is_split_k(m, n, None, torch.cuda.get_device_properties(0).multi_processor_count)
            split = 4  # K6 at every shape: n_streams > 1
            c8, c4 = _cold_copies(w8, m), _cold_copies(w4, m)
            runs = {
                "k5": ([lambda w=w: qmm.quantized_matmul(x, w["q"], w["s"], n_streams=1) for w in c8],
                       lambda: qmm.quantized_matmul_plain(x, w8["q"], w8["s"]), w8),
                "k6": ([lambda w=w: qmm.quantized_matmul(x, w["q"], w["s"], n_streams=split) for w in c8],
                       lambda: qmm.quantized_matmul_plain(x, w8["q"], w8["s"], split), w8),
                "k7": ([lambda w=w: qmm.quantized_matmul4(x, w["q4"], w["s"]) for w in c4],
                       lambda: qmm.quantized_matmul4_plain(x, w4["q4"], w4["s"]), w4),
            }
            rec = {"W": name, "M": m, "K": k, "N": n, "rule_splits": auto, "k6_streams": split,
                   "weight_copies": [len(c8), len(c4)]}
            for key, (kerns, plain, w) in runs.items():
                kern = kerns[0]
                routes = dict(qmm.route_launches)
                out, ref = kern(), plain()
                again = kern()
                torch.cuda.synchronize()
                rec[f"{key}_route"] = [r for r, v in qmm.route_launches.items() if v != routes[r]]
                rec[f"{key}_max_abs_vs_plain"] = max_abs(out, ref)
                rec[f"{key}_rel_vs_plain"] = max_rel(out, ref)
                rec[f"{key}_bitwise_repeat"] = torch.equal(out, again)
                rec[f"{key}_graph_equal"] = _graph_equal(kern)
                if (not bool(torch.isfinite(out).all()) or not rec[f"{key}_rel_vs_plain"] <= QUANT_KERNEL_REL
                        or not rec[f"{key}_bitwise_repeat"] or not rec[f"{key}_graph_equal"]):
                    raise RuntimeError(f"{key} disagrees with its plain version or itself: {rec}")
                del out, ref, again
                rec[f"{key}_ms"] = graph_ms(kerns)
                rec[f"{key}_plain_ms"] = graph_ms(plain, reps=1, iters=3)
                rec[f"{key}_call_ms"] = time_ms(kern)
                if m < QMM_ROWS[-1]:
                    rec[f"{key}_weight_GBps"] = _weight_bytes(w) / rec[f"{key}_ms"] / 1e6
                else:
                    rec[f"{key}_tflops"] = 2 * m * k * n / rec[f"{key}_ms"] / 1e9
                worst[key] = max(worst[key], rec[f"{key}_max_abs_vs_plain"])
            # K5, K6 and K7 through the register-A wgmma kernel.
            bad = {key: rec[f"{key}_route"] for key in runs if rec[f"{key}_route"] != ["wgmma"]}
            if bad:
                raise RuntimeError(f"qmm {name} M={m}: routes {bad}, want wgmma")
            for key, int4 in (("k5", False), ("k6", False), ("k7", True)):
                rec[f"{key}_bound_ms"] = bound(_qmm_bytes(k, n, m, int4), {"bf16": 2 * m * k * n})["bound_ms"]
            if m == QMM_ROWS[-1]:
                wb = _randn((k, n), gen)
                rec["bf16_gemm_ms"] = graph_ms(lambda: torch.matmul(x, wb))
                rec["bf16_gemm_tflops"] = 2 * m * k * n / rec["bf16_gemm_ms"] / 1e9
                del wb
            if name == "w_gate_up":
                rec["k5_library"] = _int8pack_mm(x, c8, w8)
                rec["k7_library"] = _int4pack_mm(x, c4, w4)
            if name in ("wo", "w_qkv", "w_down") and m < QMM_ROWS[-1]:
                rec["k6_library"] = _int8pack_mm(x, c8, w8)
            timing[name, m] = rec
            log("qmm " + json.dumps(rec))
            del x, c8, c4, runs
        del w8, w4
    torch.cuda.empty_cache()
    _qmm_f32_checks(gen)
    # The JSON line's times: the decode regime (M = 4); K6 at wo, where the
    # rule splits. Bounds: the weight codes and scales, x and out, with
    # 2*M*K*N bf16 operations. The library calls, where they run on CUDA:
    # torch._weight_int8pack_mm (K5 at w_gate_up, K6 at wo) and
    # torch._weight_int4pack_mm (K7 at w_gate_up). K5 and K7 add their
    # prefill numbers at w_gate_up, M = 1536.
    pick = {"k5": "w_gate_up", "k6": "wo", "k7": "w_gate_up"}
    dims = {name: (k, n) for name, k, n in shapes}
    m0, mp = QMM_ROWS[0], QMM_ROWS[-1]
    out = {}
    for key, name in pick.items():
        kk, n = dims[name]
        rec = timing[name, m0]
        lib_rec = rec[f"{key}_library"]
        out[key] = {"max_abs_err": worst[key], "ms": rec[f"{key}_ms"], "plain_ms": rec[f"{key}_plain_ms"],
                    **bound(_qmm_bytes(kk, n, m0, key == "k7"), {"bf16": 2 * m0 * kk * n}),
                    "library_ms": lib_rec["ms"] if lib_rec["available"] else None}
        if key != "k6":
            pre = timing[name, mp]
            out[key].update({"prefill_ms": pre[f"{key}_ms"], "prefill_bound_ms": pre[f"{key}_bound_ms"],
                             "prefill_library_ms": pre[f"{key}_library"]["ms"]
                             if pre[f"{key}_library"]["available"] else None})
    return out


def phase_k8(gen) -> dict:
    """K8 against its plain version at Llama-3-8B's layer."""
    cfg = llama.llama3_8b()
    e, q_dim, inter = cfg.hidden_size, cfg.q_dim, cfg.intermediate_size
    f = cfg.q_dim + 2 * cfg.kv_dim
    worst = 0.0
    timing = None
    for fmt in ("int8", "int4"):
        int4 = fmt == "int4"
        wo = _qmat_random(q_dim, e, gen, int4)
        w_gu = _qmat_random(e, 2 * inter, gen, int4)  # [gate | up]: per-column scales
        w_down = _qmat_random(inter, e, gen, int4)
        w_qkv = _qmat_random(e, f, gen, int4)
        norm = _randn((e,), gen, torch.float32).abs() + 0.5
        next_norm = _randn((e,), gen, torch.float32).abs() + 0.5
        for m in TAIL_ROWS:
            x = _randn((m, e), gen)
            attn = _randn((m, q_dim), gen)
            for fold in (False, True):
                kw = dict(eps=cfg.rms_norm_eps, attn_out=attn, wo=wo)
                mats = [wo, w_gu, w_down]
                if fold:
                    kw.update(next_attn_norm=next_norm, next_w_qkv=w_qkv)
                    mats.append(w_qkv)
                kern = lambda: qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)  # noqa: E731
                plain = lambda: qmlp.fused_layer_tail_plain(x, norm, w_gu, w_down, **kw)  # noqa: E731
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got, ref = (got, ref) if fold else ((got,), (ref,))
                rec = {"fmt": fmt, "M": m, "fold": fold,
                       "kernels_per_tail": qmlp.fused_layer_tail.last_kernels,
                       "max_abs_vs_plain": max(max_abs(a, b) for a, b in zip(got, ref)),
                       "rel_vs_plain": max(max_rel(a, b) for a, b in zip(got, ref))}
                if (not all(bool(torch.isfinite(a).all()) for a in got)
                        or not rec["rel_vs_plain"] <= QUANT_KERNEL_REL):
                    raise RuntimeError(f"K8 disagrees with its plain version: {rec}")
                del got, ref
                rec["ms"] = graph_ms(kern)
                rec["plain_ms"] = graph_ms(plain, reps=1, iters=3)
                rec["call_ms"] = time_ms(kern)
                if m == TAIL_ROWS[0]:
                    rec["weight_GBps"] = _weight_bytes(mats) / rec["ms"] / 1e6
                log("k8 " + json.dumps(rec))
                worst = max(worst, rec["max_abs_vs_plain"])
                if (fmt, m, fold) == ("int8", TAIL_ROWS[0], True):
                    timing = rec
        del wo, w_gu, w_down, w_qkv
    torch.cuda.empty_cache()
    worst = max(worst, _k8_phi3(gen))
    _k8_graph_check(gen)
    # Bound at int8, M = 4, with the fold: the four matrices' codes and
    # scales, x, attn, out and qkv; 2*M*(Q*E + 3*E*I + E*F) bf16 operations.
    # No single PyTorch call computes the layer tail.
    m = TAIL_ROWS[0]
    macs = q_dim * e + 3 * e * inter + e * f
    nbytes = macs + 4 * (3 * e + 2 * inter + f) + m * (2 * e + q_dim + f) * 2
    return {"max_abs_err": worst, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            **bound(nbytes, {"bf16": 2 * m * macs}), "library_ms": None}


def _k8_phi3(gen) -> float:
    """K8 at Phi-3-mini's layer, int8, M = 4 with the fold: error against
    the plain version, time by graph replay, weight GB/s."""
    e, inter, q_dim, f = PHI3_TAIL["E"], PHI3_TAIL["I"], PHI3_TAIL["Q"], PHI3_TAIL["F"]
    mats = [_qmat_random(q_dim, e, gen, False), _qmat_random(e, 2 * inter, gen, False),
            _qmat_random(inter, e, gen, False), _qmat_random(e, f, gen, False)]
    wo, w_gu, w_down, w_qkv = mats
    norm = _randn((e,), gen, torch.float32).abs() + 0.5
    m = TAIL_ROWS[0]
    x, attn = _randn((m, e), gen), _randn((m, q_dim), gen)
    kw = dict(eps=1e-5, attn_out=attn, wo=wo, next_attn_norm=norm, next_w_qkv=w_qkv)
    kern = lambda: qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)  # noqa: E731
    got, ref = kern(), qmlp.fused_layer_tail_plain(x, norm, w_gu, w_down, **kw)
    torch.cuda.synchronize()
    rec = {"model": "phi3_mini", "fmt": "int8", "M": m, "fold": True,
           "kernels_per_tail": qmlp.fused_layer_tail.last_kernels,
           "max_abs_vs_plain": max(max_abs(a, b) for a, b in zip(got, ref)),
           "rel_vs_plain": max(max_rel(a, b) for a, b in zip(got, ref))}
    if not all(bool(torch.isfinite(a).all()) for a in got) or not rec["rel_vs_plain"] <= QUANT_KERNEL_REL:
        raise RuntimeError(f"K8 disagrees with its plain version at Phi-3-mini's layer: {rec}")
    rec["ms"] = graph_ms(kern)
    rec["weight_GBps"] = _weight_bytes(mats) / rec["ms"] / 1e6
    log("k8 " + json.dumps(rec))
    del mats, wo, w_gu, w_down, w_qkv
    torch.cuda.empty_cache()
    return rec["max_abs_vs_plain"]


def _k8_graph_check(gen) -> None:
    """K8's kernels are launched with programmatic dependent launch: one
    tail captured in a CUDA graph must replay to the eager call's bits."""
    e, inter, q_dim, f = 512, 1024, 512, 768
    wo, w_gu = _qmat_random(q_dim, e, gen, False), _qmat_random(e, 2 * inter, gen, False)
    w_down, w_qkv = _qmat_random(inter, e, gen, False), _qmat_random(e, f, gen, False)
    norm = _randn((e,), gen, torch.float32).abs() + 0.5
    x, attn = _randn((16, e), gen), _randn((16, q_dim), gen)
    kw = dict(eps=1e-5, attn_out=attn, wo=wo, next_attn_norm=norm, next_w_qkv=w_qkv)
    want = qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"k8_pdl_graph captured=True kernels={qmlp.fused_layer_tail.last_kernels} "
        f"replay_equals_eager={equal}")
    if not equal:
        raise RuntimeError("K8 replayed from a CUDA graph differs from the eager call")
    del graph


def _k9_bytes(lens, hkv: int, d: int, mats, e: int, f: int) -> int:
    """Bytes one K9 call must move: the int8 weights and their scales, the
    valid cache rows (K and V codes, a 4-byte scale each), x, q, out, qkv."""
    b = len(lens)
    return (_weight_bytes(mats) + sum(lens) * hkv * 2 * (d + 4)
            + b * (2 * e + 4 * hkv * d + f) * 2)


def _k9_layer(gen, cfg):
    """A random int8 decode layer of ``cfg``'s widths for K9: (layer, the
    next layer's norm and QKV, the four weight matrices)."""
    e, inter, f = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim + 2 * cfg.kv_dim
    layer = {"wo": _qmat_random(cfg.q_dim, e, gen, False),
             "mlp_norm": _randn((e,), gen, torch.float32).abs() + 0.5,
             "w_gate_up": _qmat_random(e, 2 * inter, gen, False),
             "w_down": _qmat_random(inter, e, gen, False)}
    nxt = {"attn_norm": _randn((e,), gen, torch.float32).abs() + 0.5,
           "w_qkv": _qmat_random(e, f, gen, False)}
    return layer, nxt, [layer["wo"], layer["w_gate_up"], layer["w_down"], nxt["w_qkv"]]


def phase_k9(gen) -> dict:
    """K9 against its plain version at Llama-3-8B's layer, 16 slots / 1024
    and 64 slots / 512, ragged lengths with empty slots: error, device time
    (CUDA graph replays, weights and cache cold in L2), the plain version's
    time, kernels a call, GB/s, the time of K8's stages alone (the same tail
    without wo), and two runs held bitwise equal."""
    cfg = llama.llama3_8b()
    e, inter, hq, hkv, d = (cfg.hidden_size, cfg.intermediate_size, cfg.num_q_heads,
                            cfg.num_kv_heads, cfg.head_dim)
    f = cfg.q_dim + 2 * cfg.kv_dim
    layer, nxt, mats = _k9_layer(gen, cfg)
    rng = np.random.default_rng(9)
    worst, recs = 0.0, {}
    for b, s_max in K9_SHAPES:
        lens = rng.integers(1, s_max + 1, b)
        lens[:3] = [0, 1, s_max]
        kc, ks = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
        vc, vs = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
        x, q = _randn((b, e), gen), _randn((b, hq, d), gen)
        # The post-append lengths are ``lens`` (slot 0 empty).
        ctx = megastep.build_decode_ctx(torch.tensor(lens, dtype=torch.int32, device="cuda"),
                                        torch.zeros(b, dtype=torch.bool, device="cuda"), s_max)
        args = (x, q, kc, vc, ks, vs, ctx, layer)
        kw = dict(next_attn_norm=nxt["attn_norm"], next_w_qkv=nxt["w_qkv"], eps=cfg.rms_norm_eps)
        rec = {"B": b, "S": s_max, "mean_len": float(lens.mean())}
        for fold in (False, True):
            fkw = kw if fold else {"eps": cfg.rms_norm_eps}
            got = megastep.fused_decode_layer(*args, **fkw)
            ref = megastep.fused_decode_layer_plain(*args, **fkw)
            torch.cuda.synchronize()
            ref = ref if fold else (ref, None)
            err = max(max_rel(a, r) for a, r in zip(got, ref) if r is not None)
            if (not all(bool(torch.isfinite(a.float()).all()) for a in got if a is not None)
                    or not err <= QUANT_KERNEL_REL):
                raise RuntimeError(f"K9 disagrees with its plain version: {rec} fold={fold} rel={err}")
            rec[f"rel_vs_plain_fold{int(fold)}"] = err
            worst = max(worst, max(max_abs(a, r) for a, r in zip(got, ref) if r is not None))
        rec["kernels_per_call"] = megastep.fused_decode_layer.last_kernels
        # One layer's weights (218 MB) exceed COLD_BYTES: every replay finds
        # them, and the cache, cold in L2.
        rec["ms"] = graph_ms(lambda: megastep.fused_decode_layer(*args, **kw))
        rec["plain_ms"] = graph_ms(lambda: megastep.fused_decode_layer_plain(*args, **kw), reps=1, iters=3)
        rec["tail_only_ms"] = graph_ms(lambda: qmlp.fused_layer_tail(
            x, layer["mlp_norm"], layer["w_gate_up"], layer["w_down"], eps=cfg.rms_norm_eps,
            next_attn_norm=nxt["attn_norm"], next_w_qkv=nxt["w_qkv"]))
        # Two runs give the same bits: every reduction has a fixed order.
        first, second = (megastep.fused_decode_layer(*args, **kw) for _ in range(2))
        rec["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(first, second))
        if not rec["bitwise_repeatable"]:
            raise RuntimeError(f"K9 differs between two runs: {rec}")
        del first, second
        nbytes = _k9_bytes(lens.tolist(), hkv, d, mats, e, f)
        macs = cfg.q_dim * e + 3 * e * inter + e * f
        ops = 2 * b * macs + 4 * hq * d * int(lens.sum())
        rec.update(bound(nbytes, {"bf16": ops}), GB_moved=nbytes / 1e9,
                   GBps=nbytes / rec["ms"] / 1e6, library_ms=None)
        log("k9 " + json.dumps(rec))
        recs[b, s_max] = rec
        del kc, vc, ks, vs, args
    del layer, nxt, mats
    torch.cuda.empty_cache()
    # The JSON line: the flagship shape. No PyTorch call reads an int8 cache
    # with token-wise scales, let alone with the layer's products fused.
    pick = recs[K9_SHAPES[1]]
    return {"max_abs_err": worst, "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"], "library_ms": None}


SPLIT_TAIL_ROWS = (4, 16, 64, 256)


def _kernel_split(fn, reps: int = 5) -> dict:
    """Device time of each kernel inside one call of ``fn``: ``torch.profiler``
    (CUDA activity) over ``reps`` calls, weights cold in L2 (one layer's
    exceed it).  A kernel launched with programmatic dependent launch starts
    before the one ahead of it ends, so each kernel is charged the time from
    the end of the kernel before it (or its own start, if later) to its own
    end: the charges add up to the call's span.  Returns {"kernels": [[name,
    launches a call, us a call], ...] in the order they first ran, "span_us"},
    or {"kernels": "not measured"} when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
           and ev.time_range.end > ev.time_range.start]
    evs.sort(key=lambda ev: ev.time_range.start)
    order, rows, prev_end = [], {}, None
    for ev in evs:
        name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.name)
        name = re.sub(r"\(.*", "", name)[:80]
        start, end = ev.time_range.start, ev.time_range.end
        us = end - (start if prev_end is None else max(start, min(prev_end, end)))
        prev_end = end if prev_end is None else max(prev_end, end)
        if name not in rows:
            order.append(name)
            rows[name] = [0, 0.0]
        rows[name][0] += 1
        rows[name][1] += us
    if not order:
        return {"kernels": "not measured"}
    kernels = [[n, rows[n][0] / reps, rows[n][1] / reps] for n in order]
    # The last call's kernels: start and end in us from its first start.
    last = evs[-(len(evs) // reps):]
    t0 = last[0].time_range.start
    timeline = [[round(ev.time_range.start - t0, 1), round(ev.time_range.end - t0, 1)] for ev in last]
    return {"kernels": kernels, "span_us": sum(k[2] for k in kernels), "timeline": timeline}


def phase_split(gen) -> None:
    """The per-kernel split of one K8 call (int8, Llama-3-8B's layer, M = 4,
    16, 64 and 256, with and without the next layer's QKV) and one K9 call
    (16 slots / 1024 and 64 / 512), with the call's time by graph replay
    beside it (``ms``).  Uses only the public entry points, so the same
    function measures an earlier tree of the port (``--split-only``)."""
    cfg = llama.llama3_8b()
    e, q_dim, inter = cfg.hidden_size, cfg.q_dim, cfg.intermediate_size
    f = cfg.q_dim + 2 * cfg.kv_dim
    wo = _qmat_random(q_dim, e, gen, False)
    w_gu = _qmat_random(e, 2 * inter, gen, False)
    w_down = _qmat_random(inter, e, gen, False)
    w_qkv = _qmat_random(e, f, gen, False)
    norm = _randn((e,), gen, torch.float32).abs() + 0.5
    for m in SPLIT_TAIL_ROWS:
        x, attn = _randn((m, e), gen), _randn((m, q_dim), gen)
        for fold in (False, True):
            kw = dict(eps=cfg.rms_norm_eps, attn_out=attn, wo=wo)
            if fold:
                kw.update(next_attn_norm=norm, next_w_qkv=w_qkv)
            call = lambda: qmlp.fused_layer_tail(x, norm, w_gu, w_down, **kw)  # noqa: E731
            rec = {"M": m, "fold": fold, "ms": graph_ms(call), **_kernel_split(call)}
            log("split_k8 " + json.dumps(rec))
    # K6 (wo, w_qkv, w_down at decode rows, where the card's rule splits):
    # the product's and the reduction's kernels a call.
    for m in (4, 64):
        for name, w in (("wo", wo), ("w_qkv", w_qkv), ("w_down", w_down)):
            x = _randn((m, w["q"].shape[0]), gen)
            call = lambda: qmm.quantized_matmul(x, w["q"], w["s"])  # noqa: E731,B023
            rec = {"W": name, "M": m, "ms": graph_ms(call), **_kernel_split(call)}
            log("split_k6 " + json.dumps(rec))
    if hasattr(qmlp, "tail_matmul"):  # the tail product alone, on each matrix
        for m in (4, 64):
            for name, w in (("wo", wo), ("w_gate_up", w_gu), ("w_down", w_down), ("w_qkv", w_qkv)):
                x = _randn((m, w["q"].shape[0]), gen)
                ms = graph_ms(lambda: qmlp.tail_matmul(x, w))  # noqa: B023
                log("split_product " + json.dumps({"W": name, "M": m, "ms": ms,
                                                  "weight_GBps": _weight_bytes(w) / ms / 1e6}))
    hq, hkv, d = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    layer = {"wo": wo, "mlp_norm": norm, "w_gate_up": w_gu, "w_down": w_down}
    rng = np.random.default_rng(9)
    for b, s_max in K9_SHAPES:
        lens = rng.integers(1, s_max + 1, b)
        lens[:3] = [0, 1, s_max]
        kc, ks = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
        vc, vs = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
        x, q = _randn((b, e), gen), _randn((b, hq, d), gen)
        ctx = megastep.build_decode_ctx(torch.tensor(lens, dtype=torch.int32, device="cuda"),
                                        torch.zeros(b, dtype=torch.bool, device="cuda"), s_max)
        call = lambda: megastep.fused_decode_layer(  # noqa: E731
            x, q, kc, vc, ks, vs, ctx, layer, next_attn_norm=norm, next_w_qkv=w_qkv,
            eps=cfg.rms_norm_eps)
        rec = {"B": b, "S": s_max, "ms": graph_ms(call), **_kernel_split(call)}
        log("split_k9 " + json.dumps(rec))
        del kc, vc, ks, vs
    del wo, w_gu, w_down, w_qkv, layer
    torch.cuda.empty_cache()


def _mega_vs_unfused(backend, tree, cfg, seed: int, prompt: int = SERVE64["prompt"], low: int = 1,
                     label: str = "serve_int8_64") -> float:
    """One decode step of every slot through K9 against the unfused step
    (lean decode + K8, ``kernel.megastep = False``) on the same cache state:
    prefill every slot (``low`` to ``prompt`` tokens), run the unfused step,
    restore the lengths (its K/V writes are rewritten by the next step), run
    the K9 step, restore them again.  Returns the worst per-slot
    ||a - b|| / ||b|| of the logits."""
    rng = np.random.default_rng(seed)
    slots = list(range(backend.num_slots))
    lens = rng.integers(low, prompt + 1, len(slots))
    width = shapes.round_up(prompt, 128)
    for g in range(0, len(slots), 16):
        tokens = torch.zeros((16, width), dtype=torch.int64)
        for i, n in enumerate(lens[g: g + 16]):
            tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        backend.prefill_and_write(functools.partial(llama.forward_prefill, cfg=cfg), tree,
                                  tokens.cuda(), [int(n) - 1 for n in lens[g: g + 16]],
                                  slots[g: g + 16], [int(n) for n in lens[g: g + 16]], width)
    saved = [cache.lengths.clone() for cache in backend.caches]
    cur = rng.integers(0, cfg.vocab_size, len(slots))
    mask = np.ones(len(slots), bool)
    with config.patch({"kernel.megastep": False}), _uncaptured():
        before = (megastep.fused_decode_layer.launches, qmlp.fused_layer_tail.launches)
        ref = backend.decode(tree, cur, mask)
        if megastep.fused_decode_layer.launches != before[0] or qmlp.fused_layer_tail.launches == before[1]:
            raise RuntimeError(f"{label}: the unfused step ran K9, or not K8")
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    before = megastep.fused_decode_layer.launches
    got = backend.decode(tree, cur, mask)
    torch.cuda.synchronize()
    k9 = megastep.fused_decode_layer.launches - before
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    rel = torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"{label} k9_vs_unfused k9_calls={k9} worst_rel_err={float(rel.max())} "
        f"mean_rel_err={float(rel.mean())} argmax_agree={agree} bound={DECODE_K8_REL_BOUND}")
    if k9 != cfg.num_layers:
        raise RuntimeError(f"{label}: the K9 step ran K9 {k9} times for {cfg.num_layers} layers")
    if not bool(torch.isfinite(got).all()) or not float(rel.max()) < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: the K9 step is off the unfused step by {float(rel.max())}")
    return float(rel.max())


def _burst_vs_eager(backend, tree, seed: int, label: str = "serve_int8_64") -> None:
    """From one cache state, a graph-captured burst of BURST_CHECK_STEPS
    greedy steps and as many eager per-step K9 calls give equal tokens
    (the kernels are deterministic)."""
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    slots = backend.num_slots
    saved = [cache.lengths.clone() for cache in backend.caches]
    cur = np.random.default_rng(seed).integers(0, backend.cfg.vocab_size, slots)
    ones = np.ones(slots, bool)
    replays = backend.stats["graph_replays"]
    packed = backend.burst(tree, cur, ones, np.full(slots, 1000, np.int32),
                           np.full(slots, -1, np.int32), None, BURST_CHECK_STEPS,
                           SamplingParams(), False)
    if backend.stats["graph_replays"] - replays != BURST_CHECK_STEPS:
        raise RuntimeError(f"{label}: the checked burst did not run from its captured graph")
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    steps = []
    with _uncaptured():
        for _ in range(BURST_CHECK_STEPS):
            cur = backend.decode(tree, cur, ones).argmax(-1).cpu().numpy()
            steps.append(cur)
    equal = bool((packed[0] == np.stack(steps)).all())
    log(f"{label} graph_burst_vs_eager steps={BURST_CHECK_STEPS} slots={slots} tokens_equal={equal}")
    if not equal:
        raise RuntimeError(f"{label}: the graph-captured burst's tokens differ from eager steps")


def _later_bursts_ms(calls) -> float | None:
    """ms a step over the bursts after the first (graph replays only), from
    (name, steps, seconds) decode calls; None with fewer than two bursts."""
    bursts = [(k, dt) for n, k, dt in calls if n == "burst"][1:]
    return 1e3 * sum(dt for _, dt in bursts) / sum(k for k, _ in bursts) if bursts else None


def phase_serve_int8_64(params) -> dict:
    """The JAX package's flagship serving point on Llama-3-8B at full width
    and depth: the bf16 weights quantized to int8 and fused, 64 slots,
    max_len 512, 64 prompts of 128 tokens, 257 new tokens each, decode in
    bursts of 64 through K9 (one call a layer a step), CUDA graphs and one
    host fetch a burst."""
    cfg = llama.llama3_8b()
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree = quantized.fuse_projections(quantized.quantize_params(params))
    torch.cuda.synchronize()
    log(f"serve_int8_64 quantize_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={_weight_bytes(tree) / 1e9:.3f}")
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(tree, cfg, num_slots=SERVE64["slots"], max_len=SERVE64["max_len"],
                 cache_dtype=torch.int8, prefill_bucket=SERVE64["bucket"], device="cuda")
    backend = eng._backend
    if backend.route(tree) != "mega":
        raise RuntimeError("serve_int8_64: the 64-slot int8 step does not route to K9")
    rng = np.random.default_rng(64)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, SERVE64["prompt"]).tolist(),
                       max_new_tokens=SERVE64["new"]) for _ in range(SERVE64["slots"])]
    timers = {"prefill_s": 0.0, "decode_s": 0.0, "calls": []}
    dec = {k: 0 for k in _counts()}
    prefills = []
    orig = {name: getattr(backend, name) for name in ("prefill_and_write", "decode", "burst")}

    def timed_prefill(prefill_fn, params_, tokens, last_pos, *rest):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = orig["prefill_and_write"](prefill_fn, params_, tokens, last_pos, *rest)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t
        prefills.append((tokens.clone(), list(last_pos), logits.clone()))
        return logits

    def timed(name):
        def run(*args):
            torch.cuda.synchronize()
            before = _counts()
            t = time.perf_counter()
            out = orig[name](*args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            timers["decode_s"] += dt
            timers["calls"].append((name, args[6] if name == "burst" else 1, dt))
            for k, v in _counts().items():
                dec[k] += v - before[k]
            return out
        return run

    backend.prefill_and_write = timed_prefill
    backend.decode, backend.burst = timed("decode"), timed("burst")
    _reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion(decode_burst=SERVE64["burst"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    for name, fn in orig.items():
        setattr(backend, name, fn)
    stats = dict(eng.stats)
    decode_tokens = stats["generated_tokens"] - len(reqs)
    rec = {
        "stats": stats, "backend": dict(backend.stats), "launches": launches,
        "decode_launches": dec, "wall_s": wall,
        "prefill_tok_s": stats["prefill_tokens"] / timers["prefill_s"],
        "decode_tok_s": decode_tokens / timers["decode_s"],
        "decode_ms_per_step": 1e3 * timers["decode_s"] / stats["decode_steps"],
        # Each decode call (name, steps, ms); and the bursts after the
        # first, whose first step runs eagerly and is captured.
        "decode_calls_ms": [[n, k, 1e3 * dt] for n, k, dt in timers["calls"]],
        "later_bursts_ms_per_step": _later_bursts_ms(timers["calls"]),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("serve_int8_64 " + json.dumps(rec))

    for r in reqs:
        if not r.done or len(r.output) != SERVE64["new"]:
            raise RuntimeError(f"serve_int8_64: request {r.id} ended with {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise RuntimeError(f"serve_int8_64: request {r.id} produced out-of-vocabulary tokens")
    if dec["k9"] != L * stats["decode_steps"]:
        raise RuntimeError(f"serve_int8_64: K9 ran {dec['k9']} times in {stats['decode_steps']} decode steps")
    if dec["k4"] or dec["k8"]:
        raise RuntimeError(f"serve_int8_64: K4/K8 ran in the decode steps: {dec}")
    if launches["k1"] < L * stats["prefill_forwards"] or not (launches["k5"] + launches["k6"]):
        raise RuntimeError(f"serve_int8_64: the prefill missed K1 or K5/K6: {launches}")
    if launches["sdpa_fallback"]:
        raise RuntimeError("serve_int8_64: the main path fell back to SDPA")
    bs = backend.stats
    if bs["bursts"] < 1 or bs["graph_replays"] < bs["bursts"]:
        raise RuntimeError(f"serve_int8_64: no burst, or one that replayed no graph: {bs}")

    plain_cfg = llama.llama3_8b(attention_impl="sdpa")
    worst = 0.0
    for tokens, last_pos, logits in prefills:
        with config.patch({"kernel.qmm": False, "kernel.qmlp": False}):
            ref, _ = llama.forward_prefill(tree, tokens, plain_cfg,
                                           last_pos=torch.tensor(last_pos, device="cuda"))
        if not bool(torch.isfinite(logits).all()) or logits.shape != ref.shape:
            raise RuntimeError("serve_int8_64: prefill logits are not finite or have the wrong shape")
        rel = torch.linalg.vector_norm(logits - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
        worst = max(worst, float(rel.max()))
    log(f"serve_int8_64 prefill groups={len(prefills)} worst_rel_err={worst} bound={PREFILL_REL_BOUND}")
    if not worst < PREFILL_REL_BOUND:
        raise RuntimeError(f"serve_int8_64: prefill logits off by {worst} relative")

    _mega_vs_unfused(backend, tree, cfg, seed=65)
    _burst_vs_eager(backend, tree, seed=66)
    del eng, backend, tree, prefills
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _paged_pool(gen, kind: str, ps: int, pool: int, hkv: int, d: int):
    """K and V pages of a pool: int8 or e4m3 with token scales, token-packed
    int4 (pages of ps/2 byte rows) with token scales, or bf16, fp16 or
    fp32."""
    kf = _randn((hkv, pool, ps, d), gen, torch.float32)
    vf = _randn((hkv, pool, ps, d), gen, torch.float32)
    if kind in FLOAT_CACHES:
        return kf.to(FLOAT_CACHES[kind]), vf.to(FLOAT_CACHES[kind]), None, None
    if kind == "int4":
        (k, ks), (v, vs) = (quant.quantize_int4_values(x, reduction_dim=-1) for x in (kf, vf))
        return quant.pack_int4(k, axis=2), quant.pack_int4(v, axis=2), ks, vs
    fn = quant.dynamically_quantize_int8 if kind == "int8" else quant.dynamically_quantize_fp8
    (k, ks), (v, vs) = (fn(x, reduction_dim=-1) for x in (kf, vf))
    return k, v, ks, vs


def _gathered_rows(pages, scales, table):
    """Each slot's pages in table order as contiguous (B, Hkv, S, D) rows
    (codes or bf16; token-packed int4 pages unpacked) and (B, Hkv, S)
    scales: K4's slot-cache layout."""
    if scales is not None and scales.shape[2] == 2 * pages.shape[2]:
        pages = quant.unpack_int4(pages, axis=2)
    b, pps = table.shape
    hkv, _, ps, d = pages.shape
    rows = pages[:, table.long()].permute(1, 0, 2, 3, 4).reshape(b, hkv, pps * ps, d).contiguous()
    sc = None
    if scales is not None:
        sc = scales[:, table.long()].permute(1, 0, 2, 3).reshape(b, hkv, pps * ps).contiguous()
    return rows, sc


def _k10_vs_plain(q, pages, lens_np, lens, table) -> dict:
    """K10 against its plain version and the fp32 oracle over the slots'
    gathered rows: the record of :func:`decode_vs_plain` with the oracle's
    RMSE and the empty slots' exact zeros.  Raises where it disagrees."""
    k, v, ks, vs = pages
    out = paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs,
                                 pages_per_block=1)
    plain = paged_decode_attention_plain(q, k, v, lens, table, ks, vs)
    (kd, ksd), (vd, vsd) = _gathered_rows(k, ks, table), _gathered_rows(v, vs, table)
    kdq = kd.float() if ksd is None else kd.float() * ksd[..., None]
    vdq = vd.float() if vsd is None else vd.float() * vsd[..., None]
    oracle = torch.zeros(q.shape, device="cuda")
    for i, n in enumerate(lens_np.tolist()):
        if n:
            oracle[i] = sdpa_reference(q[i : i + 1, :, None].float(), kdq[i : i + 1, :, :n],
                                       vdq[i : i + 1, :, :n], out_dtype=torch.float32)[0, :, 0]
    torch.cuda.synchronize()
    rec = {**decode_vs_plain(out, plain, lens_np.tolist()), "rmse_vs_oracle": rmse(out, oracle),
           "zero_row_exact": all(bool((out[i] == 0).all()) for i, n in enumerate(lens_np.tolist()) if not n)}
    if (not bool(torch.isfinite(out.float()).all()) or not decode_close(rec)
            or not rec["rmse_vs_oracle"] < RMSE_BAR or not rec["zero_row_exact"]):
        raise RuntimeError(f"K10 disagrees: {rec}")
    return rec


def phase_k10(gen) -> dict:
    """K10 against its plain version and the fp32 oracle at Llama-3-8B's
    attention shapes over a shuffled page pool (int8 and bf16 pages of 128
    and 256 tokens, int4 and e4m3 pages of 128), bitwise equal across two
    runs and under graph capture; device time by graph replay with the pool
    cold in L2 (copies of the pool cycled past COLD_BYTES), the plain
    version's time, GB/s, and K4 over the same rows laid out contiguously;
    then fault 11's geometry (``k10_geometry``: a GQA group of 32, pages of
    8 and 512 tokens) and other head dims (``k10_d256``, ``k10_width``)."""
    cfg = llama.llama3_8b()
    b, hq, hkv, d = K10_SLOTS, cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(10)
    lens_np = rng.integers(1, K10_MAX_LEN + 1, b)
    lens_np[0], lens_np[1] = 0, K10_MAX_LEN
    lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
    q = _randn((b, hq, d), gen)
    worst, recs = 0.0, {}
    for ps in K10_PAGE_SIZES:
        pps = K10_MAX_LEN // ps
        pool = b * pps + K10_SPARE_PAGES
        table = torch.from_numpy(rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)).cuda()
        kinds = VERIFY_KINDS if ps == PAGED16["page_size"] else ("int8", "bf16")
        for kind in kinds:
            k, v, ks, vs = _paged_pool(gen, kind, ps, pool, hkv, d)
            args = (q, k, v, lens, table)
            kw = {"k_scale_pages": ks, "v_scale_pages": vs}
            out = paged_decode_attention(*args, **kw)
            rec = {"page_size": ps, "pages": kind, "B": b, "lengths_sum": int(lens_np.sum()),
                   **_k10_vs_plain(q, (k, v, ks, vs), lens_np, lens, table),
                   "bitwise_two_runs": torch.equal(out, paged_decode_attention(*args, **kw)),
                   "graph_equal": _graph_equal(lambda: paged_decode_attention(*args, **kw))}
            if not rec["bitwise_two_runs"] or not rec["graph_equal"]:
                raise RuntimeError(f"K10 is not repeatable: {rec}")
            worst = max(worst, rec["max_abs_vs_plain"])
            del out
            # The valid page rows' bytes: codes (half a byte an element for
            # int4) and fp32 scales.
            row_bytes = d * k.element_size() // (2 if kind == "int4" else 1) + (4 if ks is not None else 0)
            page_bytes = int(lens_np.sum()) * hkv * 2 * row_bytes
            # The pool cold in L2: copies of it cycled past COLD_BYTES.
            pool_bytes = sum(t.numel() * t.element_size() for t in (k, v, ks, vs) if t is not None)
            n = max(1, math.ceil(COLD_BYTES / pool_bytes))
            pools = [(k, v, ks, vs)] + [tuple(None if t is None else t.clone() for t in (k, v, ks, vs))
                                         for _ in range(n - 1)]
            rec["pool_copies"] = n
            rec["ms"] = graph_ms([lambda p=p: paged_decode_attention(
                q, p[0], p[1], lens, table, k_scale_pages=p[2], v_scale_pages=p[3]) for p in pools])
            rec["plain_ms"] = graph_ms(lambda: paged_decode_attention_plain(*args, ks, vs),
                                       reps=1, iters=3)
            rec["call_ms"] = time_ms(lambda: paged_decode_attention(*args, **kw))
            rec["GBps"] = page_bytes / rec["ms"] / 1e6
            del pools
            # K4 over the same rows, contiguous (int4 packed along the head
            # dim, K4's layout), cold likewise.
            (kd, ksd), (vd, vsd) = _gathered_rows(k, ks, table), _gathered_rows(v, vs, table)
            if kind == "int4":
                kd, vd = quant.pack_int4(kd), quant.pack_int4(vd)
            n4 = max(1, math.ceil(COLD_BYTES / (kd.numel() * kd.element_size() * 2)))
            caches = [(kd, vd, ksd, vsd)] + [tuple(None if t is None else t.clone() for t in (kd, vd, ksd, vsd))
                                               for _ in range(n4 - 1)]
            rec["k4_same_rows_ms"] = graph_ms([lambda c=c: decode_attention(
                q, c[0], c[1], lens, k_scale=c[2], v_scale=c[3]) for c in caches])
            # Bound: the valid page rows (codes and fp32 scales), q, out, the
            # table and the lengths, at the memory rate; the flops bind nothing.
            nbytes = page_bytes + 2 * b * hq * d * 2 + table.numel() * 4 + b * 4
            rec.update(bound(nbytes), library_ms=None)
            log("k10 " + json.dumps(rec))
            recs[ps, kind] = rec
            del caches, kd, vd, ksd, vsd, k, v, ks, vs, args
        torch.cuda.empty_cache()
    for g_hq, g_hkv, g_ps in K10_GEOMETRY:
        worst = max(worst, _k10_case(gen, d, g_hq, g_hkv, g_ps, "k10_geometry",
                                     ("int8", "bf16", "int4", "e4m3")))
    worst = max(worst, _k10_case(gen, 256, D256_MODEL["num_q_heads"], D256_MODEL["num_kv_heads"], 128,
                                 "k10_d256"))
    for dw in ANY_WIDTHS:
        hq_w, hkv_w = ((D96_MODEL["num_q_heads"], D96_MODEL["num_kv_heads"]) if dw == 96
                       else (D256_MODEL["num_q_heads"], D256_MODEL["num_kv_heads"]))
        kinds = VERIFY_KINDS if dw in LOWBIT_WIDTHS else ("int8", "bf16")
        worst = max(worst, _k10_case(gen, dw, hq_w, hkv_w, 128, "k10_width", kinds))
    vworst, verify = _k10_verify(gen)
    # The JSON line: the serving point's pages (int8, 128 tokens). No
    # PyTorch call reads an int8 page pool through a table.
    pick = recs[PAGED16["page_size"], "int8"]
    return {"max_abs_err": max(worst, vworst), "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"], "library_ms": None,
            **verify}


def _k10_verify(gen) -> tuple:
    """K10 in verify mode (ops/paged.py:459-463 of the JAX package): 16
    slots up to 1024 rows (one empty, one full, every other at least T)
    over a shuffled pool of 128-token pages, T candidates a head, GQA
    groups ``VERIFY_G`` over 8 KV heads, every page kind, against its plain
    version; then at T = 5 over Llama-3-8B's heads the device time, cold,
    by graph replay (int8 and bf16 pages; for bf16 SDPA with the (B, Hq, T,
    S) mask over the same rows gathered contiguous, the gather untimed).
    Returns (worst error, the JSON line's verify keys)."""
    b, hkv, d, ps = K10_SLOTS, 8, 128, PAGED16["page_size"]
    pps = K10_MAX_LEN // ps
    pool = b * pps + K10_SPARE_PAGES
    rng = np.random.default_rng(12)
    lens_np = rng.integers(max(VERIFY_T), K10_MAX_LEN + 1, b)
    lens_np[0], lens_np[1] = 0, K10_MAX_LEN
    lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
    table = torch.from_numpy(rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)).cuda()
    worst = 0.0
    for t in VERIFY_T:
        for g in VERIFY_G:
            for kind in VERIFY_KINDS:
                q = _randn((b, hkv * g, t, d), gen)
                k, v, ks, vs = _paged_pool(gen, kind, ps, pool, hkv, d)
                before = paged_decode_attention.verify_launches
                out = paged_decode_attention(q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs,
                                             pages_per_block=1)
                launched = paged_decode_attention.verify_launches - before
                plain = paged_decode_attention_plain(q, k, v, lens, table, ks, vs)
                torch.cuda.synchronize()
                rec = _verify_check("k10_verify", {"pages": kind, "T": t, "G": g}, out, plain,
                                    lens_np.tolist(), launched)
                worst = max(worst, rec["max_abs_vs_plain"])
                del q, k, v, ks, vs, out, plain
    torch.cuda.empty_cache()
    t, hq = VERIFY_TIMED_T, 32
    times = {}
    for kind in ("int8", "bf16"):
        q = _randn((b, hq, t, d), gen)
        pages = _paged_pool(gen, kind, ps, pool, hkv, d)
        nbytes = sum(x.numel() * x.element_size() for x in pages if x is not None)
        copies = [pages] + [tuple(None if x is None else x.clone() for x in pages)
                            for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)) - 1)]
        library = None
        if kind == "bf16":
            rows = [(_gathered_rows(p[0], None, table)[0][1:], _gathered_rows(p[1], None, table)[0][1:])
                    for p in copies]
            mask = _verify_mask(lens[1:], t, hq, pps * ps)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ref = sdpa(q[1:], rows[0][0], rows[0][1], attn_mask=mask, enable_gqa=True)
            got = paged_decode_attention(q, pages[0], pages[1], lens, table, pages_per_block=1)[1:]
            log(f"k10_verify_library max_abs_vs_k10={max_abs(got, ref)}")
            by_pool = {id(p[0]): r for p, r in zip(copies, rows)}

            def library(kp, _vp, _ks, _vs):
                kr, vr = by_pool[id(kp)]
                return sdpa(q[1:], kr, vr, attn_mask=mask, enable_gqa=True)
        row_bytes = d * pages[0].element_size() + (4 if pages[2] is not None else 0)
        valid = int(lens_np.sum()) * hkv * 2 * row_bytes + 2 * q.numel() * 2 + table.numel() * 4
        times[kind] = _verify_timing(
            f"k10_verify_time pages={kind} T={t} G={hq // hkv}",
            lambda kp, vp, ks, vs: paged_decode_attention(q, kp, vp, lens, table, k_scale_pages=ks,
                                                          v_scale_pages=vs, pages_per_block=1),
            lambda kp, vp, ks, vs: paged_decode_attention_plain(q, kp, vp, lens, table, ks, vs),
            copies, valid, library)
        del copies, pages, q
    torch.cuda.empty_cache()
    return worst, {"verify_ms": times["int8"]["ms"], "verify_plain_ms": times["int8"]["plain_ms"],
                   "verify_bound_ms": times["int8"]["bound_ms"],
                   "verify_library_ms": times["bf16"]["library_ms"], "verify_bf16_ms": times["bf16"]["ms"]}


def _k10_case(gen, d: int, hq: int, hkv: int, ps: int, label: str, kinds=("int8", "bf16")) -> float:
    """K10 at head dim d, hq / hkv heads and pages of ps tokens (16 slots up
    to K10_MAX_LEN over a shuffled pool) over pages of ``kinds``, against
    its plain version and the fp32 oracle; device time by graph replay and
    whether the card's plan moves rows by TMA boxes or cp.async."""
    b = K10_SLOTS
    rng = np.random.default_rng(11 + ps)
    lens_np = rng.integers(1, K10_MAX_LEN + 1, b)
    lens_np[0], lens_np[1] = 0, K10_MAX_LEN
    lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
    pps = -(-K10_MAX_LEN // ps)
    pool = b * pps + K10_SPARE_PAGES
    table = torch.from_numpy(rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)).cuda()
    q = _randn((b, hq, d), gen)
    worst = 0.0
    for kind in kinds:
        pages = _paged_pool(gen, kind, ps, pool, hkv, d)
        k, v, ks, vs = pages
        plan = card_plan(cache_kind(k.dtype, kind == "int4", pages=True), b, hq, hkv, d, pps * ps, ps)
        rec = {"D": d, "page_size": ps, "pages": kind, "B": b, "Hq": hq, "Hkv": hkv,
               "tma": plan["tma"], "segments": plan["segments"],
               **_k10_vs_plain(q, pages, lens_np, lens, table)}
        rec["ms"] = graph_ms(lambda: paged_decode_attention(
            q, k, v, lens, table, k_scale_pages=ks, v_scale_pages=vs, pages_per_block=1))
        log(f"{label} " + json.dumps(rec))
        worst = max(worst, rec["max_abs_vs_plain"])
        del pages, k, v, ks, vs
    torch.cuda.empty_cache()
    return worst


def _paged_k10_vs_plain(label: str, backend, tree, cfg, width: int, seed: int) -> None:
    """Fill every slot by whole-prompt prefill, then one decode step of all
    slots through K10 against the same step with K10's plain version on the
    same pages (the lengths restored between: the step rewrites the same
    rows), then a graph-captured burst of BURST_CHECK_STEPS against as many
    eager steps, token for token.  Releases the slots after."""
    from quantumattention_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    slots = list(range(backend.num_slots))
    lens = rng.integers(width // 2, width + 1, len(slots))
    for g in range(0, len(slots), 8):
        tokens = torch.zeros((len(slots[g: g + 8]), width), dtype=torch.int64)
        for i, n in enumerate(lens[g: g + 8]):
            tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        for s in slots[g: g + 8]:
            backend.alloc.allocate(s, width + 2 * BURST_CHECK_STEPS, backend.page_size)
        backend.prefill_and_write(functools.partial(llama.forward_prefill, cfg=cfg), tree,
                                  tokens.cuda(), [int(n) - 1 for n in lens[g: g + 8]],
                                  slots[g: g + 8], [int(n) for n in lens[g: g + 8]], width)
    saved = backend.alloc.lengths.copy()
    cur = rng.integers(0, cfg.vocab_size, len(slots))
    mask = np.ones(len(slots), bool)

    # An MoE model's kernel step takes the plain step's expert choices
    # (``_moe_routing``; a dense model has none to record).
    routing = []
    kernel = backends.paged_decode_attention
    backends.paged_decode_attention = plain_k10_call
    try:
        before = paged_decode_attention.launches
        with _moe_routing(routing), _uncaptured():
            ref = backend.decode(tree, cur, mask)
        if paged_decode_attention.launches != before:
            raise RuntimeError(f"{label}: the plain step launched K10")
    finally:
        backends.paged_decode_attention = kernel
    backend.alloc.lengths[:] = saved
    before = paged_decode_attention.launches
    with _moe_routing(routing, replay=True), _uncaptured() if routing else contextlib.nullcontext():
        got = backend.decode(tree, cur, mask)
    torch.cuda.synchronize()
    k10 = paged_decode_attention.launches - before
    rel = torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"{label} k10_vs_plain k10_calls={k10} worst_rel_err={float(rel.max())} "
        f"mean_rel_err={float(rel.mean())} argmax_agree={agree} bound={DECODE_K8_REL_BOUND}")
    if k10 != cfg.num_layers:
        raise RuntimeError(f"{label}: the step ran K10 {k10} times for {cfg.num_layers} layers")
    if not bool(torch.isfinite(got).all()) or not float(rel.max()) < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: the K10 step is off its plain step by {float(rel.max())}")

    backend.alloc.lengths[:] = saved
    replays = backend.stats["graph_replays"]
    packed = backend.burst(tree, cur, mask, np.full(len(slots), 1000, np.int32),
                           np.full(len(slots), -1, np.int32), None, BURST_CHECK_STEPS,
                           SamplingParams(), False)
    if backend.stats["graph_replays"] - replays != BURST_CHECK_STEPS:
        raise RuntimeError(f"{label}: the checked burst did not run from its captured graph")
    backend.alloc.lengths[:] = saved
    steps = []
    with _uncaptured():
        for _ in range(BURST_CHECK_STEPS):
            cur = backend.decode(tree, cur, mask).argmax(-1).cpu().numpy()
            steps.append(cur)
    equal = bool((packed[0] == np.stack(steps)).all())
    log(f"{label} graph_burst_vs_eager steps={BURST_CHECK_STEPS} slots={len(slots)} "
        f"tokens_equal={equal}")
    if not equal:
        raise RuntimeError(f"{label}: the graph-captured burst's tokens differ from eager steps")
    for s in slots:
        backend.release(s)


def phase_serve_paged_prefix_16(params) -> dict:
    """The JAX package's prefix-caching point on Llama-3-8B at full width
    and depth: the int8 fused tree on the paged backend, 16 prompts of 512
    tokens sharing a 384-token prefix, served cold and then hot, decode in
    bursts of 64 through K10 (one call a layer a step)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree = quantized.fuse_projections(quantized.quantize_params(params))
    torch.cuda.synchronize()
    log(f"serve_paged_prefix_16 quantize_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={_weight_bytes(tree) / 1e9:.3f}")
    total = _serve_paged("serve_paged_prefix_16", tree, PAGED16, torch.int8, False,
                         plain_flags={"kernel.qmm": False, "kernel.qmlp": False})
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _serve_paged(label: str, tree, shape: dict, cache_dtype, kv_int4: bool, plain_flags,
                 cfg=None) -> dict:
    """``tree`` on the paged backend at ``shape`` (slots, max_len, pages,
    chunks, a pool, prompts sharing a prefix, new tokens, bursts): served
    cold and then hot (every prompt's shared pages a prefix hit), decode in
    bursts through K10 (one call a layer a step); final-chunk logits hot
    against cold and cold against a plain whole-prompt run (SDPA attention,
    ``plain_flags``), then one decode step through K10 against its plain
    version and a graph-captured burst against eager steps.  Returns the
    launches of both rounds.  ``cfg``: Llama-3-8B's unless given; the plain
    run takes its prompts ``shape["plain_rows"]`` (8) at a time."""
    cfg = llama.llama3_8b() if cfg is None else cfg
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(tree, cfg, num_slots=shape["slots"], max_len=shape["max_len"],
                 cache_dtype=cache_dtype, kv_int4=kv_int4, cache_backend="paged",
                 page_size=shape["page_size"], num_pages=shape["num_pages"],
                 prefill_chunk=shape["chunk"], prefix_cache=True, device="cuda")
    backend = eng._backend
    rng = np.random.default_rng(16)
    shared = rng.integers(0, cfg.vocab_size, shape["shared"]).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, shape["prompt"] - shape["shared"]).tolist()
               for _ in range(shape["slots"])]
    orig = {name: getattr(backend, name) for name in ("prefill_chunk", "decode", "burst")}
    total = {k: 0 for k in _counts()}
    last_logits, plain_logits = {}, {}
    # Low-bit pages: a chunk reads its prefix quantized, so its logits are
    # held against the same chunk through plain attention (``same_path``),
    # not against an unquantized whole-prompt run or the other round.
    same_path = shape.get("same_path_check", False)
    for rnd in ("cold", "hot"):
        timers = {"prefill_s": 0.0, "decode_s": 0.0, "burst_s": 0.0, "burst_steps": 0,
                  "step_s": 0.0, "steps": 0}
        dec = {k: 0 for k in _counts()}
        chunks = []
        peak_pages = [0]
        pool = backend.alloc

        def in_use():
            peak_pages[0] = max(peak_pages[0], pool.num_pages - pool.free_pages - pool.evictable_pages)

        def timed_chunk(params_, tokens, req, off, tc):
            if same_path and off > 0 and off + tc == len(req.prompt):
                # The same chunk through K1's plain version first, over the
                # same quantized prefix (its own page writes are rewritten
                # by the kernel's run below).  An MoE model's plain run
                # takes the expert choices of a kernel run of the chunk
                # (``_moe_routing``).  Neither run is the main path's, so
                # both stay out of the round's counts.
                routing = []
                with _uncounted():
                    if cfg.num_experts:
                        with _moe_routing(routing):
                            orig["prefill_chunk"](params_, tokens, req, off, tc)
                    kernel = backends.flash_attention
                    backends.flash_attention = flash_attention_plain
                    try:
                        with _moe_routing(routing, replay=True) if cfg.num_experts else contextlib.nullcontext():
                            plain_logits[rnd, req.id % shape["slots"]] = orig["prefill_chunk"](
                                params_, tokens, req, off, tc)[0, tc - 1].clone()
                    finally:
                        backends.flash_attention = kernel
            torch.cuda.synchronize()
            before = flash_attention.launches
            t = time.perf_counter()
            logits = orig["prefill_chunk"](params_, tokens, req, off, tc)
            torch.cuda.synchronize()
            timers["prefill_s"] += time.perf_counter() - t
            chunks.append((off, tc, flash_attention.launches - before))
            if off + tc == len(req.prompt):
                last_logits[rnd, req.id % shape["slots"]] = logits[0, tc - 1].clone()
            in_use()
            return logits

        def timed(name):
            def run(*args):
                torch.cuda.synchronize()
                before = _counts()
                t = time.perf_counter()
                out = orig[name](*args)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t
                timers["decode_s"] += sec
                # A burst's n_steps is its 7th argument; decode is one step.
                kind, n = ("burst", args[6]) if name == "burst" else ("step", 1)
                timers[f"{kind}_s"] += sec
                timers[f"{kind}_steps" if kind == "burst" else "steps"] += n
                for k, v in _counts().items():
                    dec[k] += v - before[k]
                in_use()
                return out
            return run

        backend.prefill_chunk = timed_chunk
        backend.decode, backend.burst = timed("decode"), timed("burst")
        stats0, bstats0 = dict(eng.stats), dict(backend.stats)
        _reset_counts()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=shape["new"]) for p in prompts]
        eng.run_to_completion(decode_burst=shape["burst"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        for name, fn in orig.items():
            setattr(backend, name, fn)
        for k, v in launches.items():
            total[k] += v
        stats = {k: eng.stats[k] - stats0[k] for k in eng.stats}
        bstats = {k: backend.stats[k] - bstats0[k] for k in backend.stats}
        decode_tokens = stats["generated_tokens"] - len(reqs)
        rec = {
            "round": rnd, "stats": stats, "backend": bstats, "launches": launches,
            "decode_launches": dec, "wall_s": wall,
            "prefill_tok_s": stats["prefill_tokens"] / timers["prefill_s"],
            "prefill_s": timers["prefill_s"],
            "decode_tok_s": decode_tokens / timers["decode_s"],
            "decode_ms_per_step": 1e3 * timers["decode_s"] / stats["decode_steps"],
            "burst_ms_per_step": 1e3 * timers["burst_s"] / max(1, timers["burst_steps"]),
            "single_step_ms": 1e3 * timers["step_s"] / max(1, timers["steps"]),
            "steps_in_bursts": timers["burst_steps"], "single_steps": timers["steps"],
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
            "peak_pages_in_use": peak_pages[0], "pool_pages": pool.num_pages,
            "chunk_offsets": sorted({off for off, _, _ in chunks}),
        }
        log(f"{label} " + json.dumps(rec))

        for r in reqs:
            if not r.done or len(r.output) != shape["new"]:
                raise RuntimeError(f"{label} {rnd}: request {r.id} ended with {len(r.output)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                raise RuntimeError(f"{label} {rnd}: out-of-vocabulary tokens")
        # Hot: each prompt's whole pages but the one holding its last token
        # (the cold round published them all; that is the shared prefix at
        # the prefix-caching point).
        hits = 0 if rnd == "cold" else shape["slots"]
        reused = (shape["prompt"] - 1) // shape["page_size"] * shape["page_size"]
        if stats["prefix_hits"] != hits or stats["prefix_tokens_reused"] != hits * reused:
            raise RuntimeError(f"{label} {rnd}: prefix hits {stats}")
        if dec["k10"] != L * stats["decode_steps"] or dec["k4"] or dec["k9"]:
            raise RuntimeError(f"{label} {rnd}: decode launches {dec} for "
                               f"{stats['decode_steps']} steps")
        if any(k1 != L for _, _, k1 in chunks) or len(chunks) != stats["prefill_forwards"]:
            raise RuntimeError(f"{label} {rnd}: K1 missed a chunk forward: {chunks}")
        want_offs = list(range(0 if rnd == "cold" else reused, shape["prompt"], shape["chunk"]))
        if rec["chunk_offsets"] != want_offs:
            raise RuntimeError(f"{label} {rnd}: chunk offsets {rec['chunk_offsets']}")
        if launches["sdpa_fallback"]:
            raise RuntimeError(f"{label}: the main path fell back to SDPA")
        if bstats["bursts"] < 1 or bstats["graph_replays"] < bstats["bursts"]:
            raise RuntimeError(f"{label} {rnd}: no burst, or one that replayed no graph: {bstats}")

    # Hot logits against cold, cold against a plain whole-prompt run of the
    # same tree (SDPA attention, the plain weight products); low-bit pages:
    # each round's final chunk against the same chunk through plain K1.
    plain_cfg = dataclasses.replace(cfg, attention_impl="sdpa")
    rows = shape.get("plain_rows", 8)
    worst = {"hot_vs_cold": 0.0, "cold_vs_plain": 0.0}
    if same_path:
        worst = {f"{rnd}_vs_plain_chunk": max(rel_fro(last_logits[rnd, i], plain_logits[rnd, i])
                                              for i in range(shape["slots"]))
                 for rnd in ("cold", "hot")}
    for g in range(0, 0 if same_path else shape["slots"], rows):
        tokens = torch.tensor(prompts[g: g + rows], device="cuda")
        last = torch.full((tokens.shape[0],), shape["prompt"] - 1, device="cuda")
        with config.patch(plain_flags):
            ref, _ = llama.forward_prefill(tree, tokens, plain_cfg, last_pos=last)
        for i in range(tokens.shape[0]):
            cold, hot = last_logits["cold", g + i], last_logits["hot", g + i]
            if not bool(torch.isfinite(hot).all() and torch.isfinite(cold).all()):
                raise RuntimeError(f"{label}: final-chunk logits are not finite")
            worst["hot_vs_cold"] = max(worst["hot_vs_cold"], rel_fro(hot, cold))
            worst["cold_vs_plain"] = max(worst["cold_vs_plain"], rel_fro(cold, ref[i]))
        del ref
    log(f"{label} logits worst_rel_err={json.dumps(worst)} bound={PREFILL_REL_BOUND}")
    if not max(worst.values()) < PREFILL_REL_BOUND:
        raise RuntimeError(f"{label}: final-chunk logits off: {worst}")

    _paged_k10_vs_plain(label, backend, tree, cfg, shapes.round_up(shape["prompt"], shape["page_size"]),
                        seed=17)
    del eng, backend
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_serve_d256() -> dict:
    """A short check of the kernels at head dim 256 on a model: D256_MODEL
    (2 layers of the Llama block with Gemma-7B's attention width: 16 query
    heads of 256 over 8 KV heads, hidden 3072) with seeded random bf16
    weights serves D256_PROMPTS on the paged backend with chunked prefill
    (``_serve_width``)."""
    return _serve_width("serve_d256", D256_MODEL, D256_PROMPTS, seed=256)


def _serve_width(label: str, model: dict, prompt_lens: list, seed: int) -> dict:
    """A 2-layer model of the Llama block at ``model``'s attention width,
    seeded random bf16 weights, serves prompts of ``prompt_lens`` tokens on
    the paged backend with chunked prefill (WIDTH_SERVE). Checks: every
    request completes, K1 runs in every chunk forward (with q_offset > 0
    after the first chunk) and K10 in every decode step, no SDPA fallback,
    and each prompt's last logits against a plain-attention whole-prompt run
    within PREFILL_REL_BOUND."""
    cfg = llama.llama3_8b(**model)
    L = cfg.num_layers
    params = llama.init_params(torch.Generator("cuda").manual_seed(seed), cfg, "cuda")
    eng = Engine(params, cfg, num_slots=len(prompt_lens), max_len=WIDTH_SERVE["max_len"],
                 cache_dtype=torch.int8, cache_backend="paged", page_size=WIDTH_SERVE["page_size"],
                 prefill_chunk=WIDTH_SERVE["chunk"], device="cuda")
    backend = eng._backend
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]
    chunks, last = [], {}
    orig = backend.prefill_chunk

    def chunk(params_, tokens, req, off, tc):
        before = flash_attention.launches
        logits = orig(params_, tokens, req, off, tc)
        chunks.append((off, flash_attention.launches - before))
        if off + tc == len(req.prompt):
            last[req.id] = logits[0, tc - 1].clone()
        return logits

    backend.prefill_chunk = chunk
    _reset_counts()
    reqs = [eng.submit(p, max_new_tokens=WIDTH_SERVE["new"]) for p in prompts]
    eng.run_to_completion()
    torch.cuda.synchronize()
    launches = _counts()
    backend.prefill_chunk = orig
    stats = dict(eng.stats)
    offsets = sorted({off for off, _ in chunks})
    plain_cfg = llama.llama3_8b(**model, attention_impl="sdpa")
    errs = []
    for r, p in zip(reqs, prompts):
        tokens = torch.tensor([p], device="cuda")
        ref, _ = llama.forward_prefill(params, tokens, plain_cfg,
                                       last_pos=torch.tensor([len(p) - 1], device="cuda"))
        errs.append(rel_fro(last[r.id], ref[0]))
    rec = {"model": model, "prompts": prompt_lens, "launches": launches, "stats": stats,
           "chunk_offsets": offsets, "prefill_rel_err": errs, "bound": PREFILL_REL_BOUND}
    log(f"{label} " + json.dumps(rec))
    if any(not r.done or len(r.output) != WIDTH_SERVE["new"] for r in reqs):
        raise RuntimeError(f"{label}: a request did not complete")
    if len(chunks) != stats["prefill_forwards"] or any(k1 != L for _, k1 in chunks):
        raise RuntimeError(f"{label}: K1 missed a chunk forward: {chunks}")
    if max(offsets) <= 0:
        raise RuntimeError(f"{label}: no chunk ran K1 with q_offset > 0")
    if launches["k10"] != L * stats["decode_steps"] or launches["sdpa_fallback"]:
        raise RuntimeError(f"{label}: decode launches {launches} for {stats['decode_steps']} steps")
    if not all(np.isfinite(errs)) or not max(errs) < PREFILL_REL_BOUND:
        raise RuntimeError(f"{label}: prefill logits off: {errs}")
    del eng, backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_d96() -> dict:
    """The head-dim-96 check (a check, not a cell): D96_MODEL (Phi-3-mini's
    attention width, 2 layers) serves D96_PROMPTS on the paged backend
    (``_serve_width``: K1 with q_offset and K10 at D = 96), then its
    gradients over D96_TRAIN_POSITIONS positions through K1, K2 and K3 (bf16
    and fp8 attention) are held against plain attention's within
    TRAIN_GRAD_BOUND, and it takes one training step through them."""
    _serve_width("d96", D96_MODEL, D96_PROMPTS, seed=96)
    cfg = llama.llama3_8b(**D96_MODEL)
    L = cfg.num_layers
    params = llama.init_params(torch.Generator("cuda").manual_seed(96), cfg, "cuda")
    rng = np.random.default_rng(96)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, D96_TRAIN_POSITIONS + 1))).to("cuda")
    _, ref = llama.loss_and_grads(params, tokens, llama.llama3_8b(**D96_MODEL, attention_impl="sdpa"))
    ref = _grad_leaves(ref)
    errs, launches = {}, {}
    for impl in ("bf16", "fp8"):
        _reset_train_counts()
        _, grads = llama.loss_and_grads(params, tokens, llama.llama3_8b(**D96_MODEL, attention_impl=impl))
        torch.cuda.synchronize()
        launches[impl] = _train_counts()
        errs[impl] = {name: rel_fro(g, ref[name]) for name, g in _grad_leaves(grads).items()}
        del grads
    _reset_train_counts()
    params, loss = llama.train_step(params, tokens, cfg)
    loss = float(loss)
    launches["train_step"] = _train_counts()
    rec = {"model": D96_MODEL, "positions": D96_TRAIN_POSITIONS, "grad_rel_fro_vs_plain": errs,
           "bounds": TRAIN_GRAD_BOUND, "launches": launches, "loss": loss}
    log("d96 train " + json.dumps(rec))
    for name, n in launches.items():
        k1_min = L if name == "bf16" else 2 * L  # the fp8 path recomputes the bf16 forward
        if n["k1"] < k1_min or n["k2"] < L or n["k3"] < L or n["sdpa_fallback"]:
            raise RuntimeError(f"d96 {name}: K1/K2/K3 missed a layer or fell back: {n}")
    for impl, e in errs.items():
        if not all(x < TRAIN_GRAD_BOUND[impl] for x in e.values()):
            raise RuntimeError(f"d96: {impl} gradients off: {e}")
    if not np.isfinite(loss):
        raise RuntimeError(f"d96: non-finite training loss {loss}")
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _reset_train_counts() -> None:
    for fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = fn.window_launches = 0
    dispatch.sdpa_fallback.calls = 0


def _train_counts() -> dict:
    return {"k1": flash_attention.launches, "k2": flash_bwd_dq.launches,
            "k3": flash_bwd_dkv.launches, "k1_window": flash_attention.window_launches,
            "k2_window": flash_bwd_dq.window_launches, "k3_window": flash_bwd_dkv.window_launches,
            "sdpa_fallback": dispatch.sdpa_fallback.calls}


def _grad_leaves(grads) -> dict:
    """The gradient leaves the training checks compare: the embedding, the
    first layer's wq, wk, wv and the last layer's w_down."""
    first, last = grads["layers"][0], grads["layers"][-1]
    return {"embed": grads["embed"], "layers.0.wq": first["wq"], "layers.0.wk": first["wk"],
            "layers.0.wv": first["wv"], f"layers.{len(grads['layers']) - 1}.w_down": last["w_down"]}


def _checked_grads(params, tokens, impl, scaling_method="head-wise"):
    """Gradients of the leaves the training phase compares, at
    GRAD_CHECK_LAYERS layers."""
    cut = {**params, "layers": params["layers"][:GRAD_CHECK_LAYERS]}
    cfg = llama.llama3_8b(num_layers=GRAD_CHECK_LAYERS, attention_impl=impl,
                          scaling_method=scaling_method)
    _, grads = llama.loss_and_grads(cut, tokens, cfg)
    return _grad_leaves(grads)


def phase_train(params) -> dict:
    """Llama-3-8B, full width and depth, 3 SGD steps over 1024 positions
    through the fp8 path (K1, K2, K3)."""
    gc.collect()  # the engine and its cache
    torch.cuda.empty_cache()
    cfg = llama.llama3_8b()
    L = cfg.num_layers
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, TRAIN_POSITIONS + 1))).to("cuda")

    with torch.no_grad():
        plain_loss = float(llama.loss_fn(params, tokens, llama.llama3_8b(attention_impl="sdpa")))
    ref = _checked_grads(params, tokens, "sdpa")
    grad_err = {}
    for impl in ("bf16", "fp8"):
        grads = _checked_grads(params, tokens, impl)
        grad_err[impl] = {name: rel_fro(g, ref[name]) for name, g in grads.items()}
        del grads
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train grads layers={GRAD_CHECK_LAYERS} rel_fro_vs_plain={json.dumps(grad_err)} "
        f"bounds={json.dumps(TRAIN_GRAD_BOUND)}")
    for impl, errs in grad_err.items():
        if not all(e < TRAIN_GRAD_BOUND[impl] for e in errs.values()):
            raise RuntimeError(f"{impl} gradients off: {errs}")

    _reset_train_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = llama.train_step(params, tokens, cfg)
        loss = float(loss)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        steps.append({"step": i, "loss": loss, "ms": 1e3 * sec,
                      "tok_s": TRAIN_POSITIONS / sec,
                      "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        log("train step " + json.dumps(steps[-1]))
    launches = _train_counts()
    first_rel = abs(steps[0]["loss"] - plain_loss) / abs(plain_loss)
    rec = {"layers": L, "positions": TRAIN_POSITIONS, "launches": launches,
           "plain_loss": plain_loss, "first_loss_rel_err": first_rel,
           "bound": LOSS_REL_BOUND}
    log("train " + json.dumps(rec))
    if not all(np.isfinite(st["loss"]) for st in steps):
        raise RuntimeError(f"non-finite training loss: {steps}")
    if launches["k1"] < 2 * L * TRAIN_STEPS:
        raise RuntimeError(f"K1 ran {launches['k1']} times in {TRAIN_STEPS} steps")
    if launches["k2"] < L * TRAIN_STEPS or launches["k3"] < L * TRAIN_STEPS:
        raise RuntimeError(f"K2/K3 ran {launches['k2']}/{launches['k3']} times in {TRAIN_STEPS} steps")
    if launches["sdpa_fallback"] != 0:
        raise RuntimeError("the training path fell back to SDPA")
    if not first_rel < LOSS_REL_BOUND:
        raise RuntimeError(f"first loss {steps[0]['loss']} vs plain {plain_loss}")
    return launches


# ---------------------------------------------------------------------------
# Sliding windows: the kernels' window checks and Mistral-7B end to end
# ---------------------------------------------------------------------------


def _pairs(keep: torch.Tensor) -> int:
    """(query, key) pairs a position mask leaves (all of them for None)."""
    return int(keep.sum())


def _k1_window_case(gen, mode: str, causal: bool, window, q_off: int, kv_off: int,
                    s: int = 1536, d: int = 128) -> dict:
    """K1 at B = 1, 32/8 heads with a window (and offsets: K/V start at
    kv_off, left + Sq rows of them) against its plain version and the fp32
    oracle on the rows that see a key (rows that see none must be zeros);
    device time by graph replay beside the same call without the window,
    and the bound of the pairs the window leaves."""
    skv = s + window[0] if kv_off else s
    args, scales, _ = _k1_inputs(1, s, mode, d, gen, skv=skv)
    kw = dict(is_causal=causal, window=window, q_offset=q_off, kv_offset=kv_off, **scales)
    out = flash_attention(*args, **kw)
    plain = flash_attention_plain(*args, scales.get("scale_q"), scales.get("scale_k"), causal, None,
                                  False, q_off, window, kv_off)
    keep = keep_mask(s, skv, causal, window, q_off, kv_off, "cuda")
    seen = keep.any(-1)
    oracle = sdpa_reference(*args, attn_mask=keep, out_dtype=torch.float32, **scales)
    torch.cuda.synchronize()
    rec = {"mode": mode, "causal": causal, "window": list(window), "q_offset": q_off,
           "kv_offset": kv_off, "Sq": s, "Skv": skv, "D": d,
           "max_abs_vs_plain": max_abs(out, plain),
           "rmse_vs_oracle": rmse(out[:, :, seen], oracle[:, :, seen]),
           "empty_rows_zero": bool((out[:, :, ~seen] == 0).all())}
    if (not bool(torch.isfinite(out).all()) or rec["max_abs_vs_plain"] > KERNEL_VS_PLAIN_ATOL
            or not rec["rmse_vs_oracle"] < RMSE_BAR or not rec["empty_rows_zero"]):
        raise RuntimeError(f"K1 with a window disagrees: {rec}")
    del plain, oracle
    nowin = {**kw, "window": None}
    rec["ms"] = graph_ms(functools.partial(flash_attention, *args, **kw))
    rec["no_window_ms"] = graph_ms(functools.partial(flash_attention, *args, **nowin))
    rec["plain_ms"] = time_ms(lambda: flash_attention_plain(
        *args, scales.get("scale_q"), scales.get("scale_k"), causal, None, False, q_off, window,
        kv_off), iters=3, warmup=1)
    pairs = 32 * _pairs(keep)
    qk = "fp8" if mode in ("head", "token") else "bf16"
    e = 1 if qk == "fp8" else 2
    nbytes = 32 * s * d * (e + 2) + 8 * skv * d * (e + 2)
    rec.update(bound(nbytes, {qk: 2 * pairs * d, "bf16": 2 * pairs * d} if qk == "fp8"
                     else {"bf16": 4 * pairs * d}))
    rec["visible_pairs"] = pairs
    log("k1_window " + json.dumps(rec))
    return rec


def _k1_window_protocol(gen) -> dict:
    """K1 at the protocol's shape (B = 16, H = 16, S = 8192, D = 128, causal)
    with Mistral's window (4095, 0), bf16 and fp8 head-wise, beside the same
    call without the window and SDPA with the boolean window mask (memory-
    efficient back end: the math one would need the whole score matrix);
    one batch entry and two heads against the fp32 oracle."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, h, s, d = PROTOCOL["B"], PROTOCOL["H"], PROTOCOL["S"], 128
    window = (WINDOW_PROTOCOL_LEFT, 0)
    q, k, v = (_randn((b, h, s, d), gen) for _ in range(3))
    (qh, sqh), (kh, skh) = (quant.quantize_head_wise(t, torch.float8_e4m3fn) for t in (q, k))
    keep = keep_mask(s, s, True, window, 0, 0, "cuda")
    pairs = b * h * _pairs(keep)
    rec = {"B": b, "H": h, "S": s, "D": d, "window": list(window), "visible_pairs": pairs}
    for name, args, scales in (("bf16", (q, k, v), {}),
                               ("fp8_head", (qh, kh, v), {"scale_q": sqh, "scale_k": skh})):
        out = flash_attention(*args, is_causal=True, window=window, **scales)
        cut = [a[:1, :2] for a in args]
        cut_scales = {key: t[:1, :2] for key, t in scales.items()}
        oracle = sdpa_reference(*cut, attn_mask=keep, out_dtype=torch.float32, **cut_scales)
        rec[f"{name}_rmse_vs_oracle"] = rmse(out[:1, :2], oracle)
        if not bool(torch.isfinite(out).all()) or not rec[f"{name}_rmse_vs_oracle"] < RMSE_BAR:
            raise RuntimeError(f"K1 with a window disagrees at the protocol shape: {rec}")
        del out, oracle
        rec[f"{name}_ms"] = time_ms(functools.partial(
            flash_attention, *args, is_causal=True, window=window, **scales), iters=5, warmup=1)
        rec[f"{name}_no_window_ms"] = time_ms(functools.partial(
            flash_attention, *args, is_causal=True, **scales), iters=5, warmup=1)
        rec[f"{name}_tflops"] = 4 * pairs * d / rec[f"{name}_ms"] / 1e9
    mask = keep[None, None]
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ref = torch.nn.functional.scaled_dot_product_attention(q[:1, :2], k[:1, :2], v[:1, :2],
                                                                   attn_mask=mask)
            rec["library_max_abs_vs_k1"] = max_abs(
                ref, flash_attention(q[:1, :2], k[:1, :2], v[:1, :2], is_causal=True, window=window))
            rec["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), iters=5, warmup=1)
    except RuntimeError as e:  # the back end refuses the mask at this shape
        rec["library_ms"] = None
        rec["library_refused"] = str(e).splitlines()[0][:120]
    rec.update(bound(b * h * s * d * 2 * 4, {"bf16": 4 * pairs * d}))
    log("k1_window_protocol " + json.dumps(rec))
    del q, k, v, qh, kh
    torch.cuda.empty_cache()
    return rec


def _k23_window(gen) -> dict:
    """K2 and K3 at B = 1, 32/8 heads, S = 1536, D = 128 with the window
    (255, 0), causal: against their plain version and the fp32 oracle's
    autograd, device times by graph replay beside the same shape without
    the window, and bounds of the pairs the window leaves."""
    b, hq, hkv, s, d = 1, 32, 8, 1536, 128
    window = (WINDOW_LEFTS[0], 0)
    q, k, v = _randn((b, hq, s, d), gen), _randn((b, hkv, s, d), gen), _randn((b, hkv, s, d), gen)
    do = _randn((b, hq, s, d), gen)
    rec = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": list(window)}
    out, (m, l) = flash_attention(q, k, v, is_causal=True, window=window, return_residuals=True)
    grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=True, window=window)
    plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=True, window=window)
    oracle = _oracle_grads(q, k, v, do, True, window)
    torch.cuda.synchronize()
    for name, g, p, o in zip(("dq", "dk", "dv"), grads, plain, oracle):
        rec[f"{name}_rel_vs_plain"] = max_rel(g, p)
        rec[f"{name}_rel_vs_oracle"] = max_rel(g, o)
        rec[f"{name}_max_abs_vs_plain"] = max_abs(g, p)
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"K2/K3 with a window gave non-finite {name}: {rec}")
    bad = [key for key, val in rec.items() if "_rel_vs_" in key and not val < GRAD_BAR]
    if bad:
        raise RuntimeError(f"K2/K3 with a window disagree ({bad}): {rec}")
    del grads, plain, oracle
    delta = row_delta(out, do)
    wargs = (q, k, v, do, m, l, delta)
    wkw = {"is_causal": True, "window": window, "stats": pack_stats(m, l, delta)}
    out0, (m0, l0) = flash_attention(q, k, v, is_causal=True, return_residuals=True)
    delta0 = row_delta(out0, do)
    args0 = (q, k, v, do, m0, l0, delta0)
    kw0 = {"is_causal": True, "stats": pack_stats(m0, l0, delta0)}
    rec["dq_ms"] = graph_ms(lambda: flash_bwd_dq(*wargs, **wkw))
    rec["dkv_ms"] = graph_ms(lambda: flash_bwd_dkv(*wargs, **wkw))
    rec["dq_no_window_ms"] = graph_ms(lambda: flash_bwd_dq(*args0, **kw0))
    rec["dkv_no_window_ms"] = graph_ms(lambda: flash_bwd_dkv(*args0, **kw0))
    rec["dq_plain_ms"] = time_ms(lambda: flash_bwd_dq_plain(*wargs, is_causal=True, window=window),
                                 iters=3, warmup=1)
    rec["dkv_plain_ms"] = time_ms(lambda: flash_bwd_dkv_plain(*wargs, is_causal=True, window=window),
                                  iters=3, warmup=1)
    pairs = hq * _pairs(keep_mask(s, s, True, window, 0, 0, "cuda"))
    reads = (hq + 2 * hkv + hq) * s * d * 2 + 3 * hq * s * 4
    rec["dq_bound"] = bound(reads + hq * s * d * 2, {"bf16": 3 * 2 * pairs * d})
    rec["dkv_bound"] = bound(reads + 2 * hkv * s * d * 2, {"bf16": 4 * 2 * pairs * d})
    log("k23_window " + json.dumps(rec))
    return rec


def _window_rows(lens, left: int, t: int) -> int:
    """Cache rows the queries of slots of these lengths see with a window
    of left extent ``left`` and ``t`` candidates a head: min(n, left + t)."""
    return sum(min(int(n), left + t) for n in lens)


def _k4_window(gen) -> dict:
    """K4 over 4 slots of 0/57/900/2047 rows with windows (255, 0) and
    (1023, 0), every cache kind, one token a head and T = 5 candidates,
    against its plain version; then int8 at T = 1 and 5 timed cold (copies
    cycled past COLD_BYTES, graph replay) beside the same call without the
    window and the bound of the in-window rows."""
    b, hq, hkv, s_max, d = 4, 32, 8, 2048, 128
    lens = [0, 57, 900, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst, times = 0.0, {}
    for left in WINDOW_LEFTS:
        for t in (1, VERIFY_TIMED_T):
            for kind in VERIFY_KINDS:
                q = _randn((b, hq, d) if t == 1 else (b, hq, t, d), gen)
                cache, _ = _k4_cache(gen, b, hkv, s_max, d, kind)
                kc, vc, ks, vs = cache
                call = functools.partial(decode_attention, q, kc, vc, lengths, k_scale=ks,
                                         v_scale=vs, window=(left, 0))
                before = decode_attention.window_launches
                out = call()
                launched = decode_attention.window_launches - before
                plain = decode_attention_plain(q, kc, vc, lengths, ks, vs, window_left=left)
                torch.cuda.synchronize()
                rec = {"cache": kind, "T": t, "window": [left, 0], "window_launches": launched,
                       **decode_vs_plain(out, plain, lens),
                       "zero_row_exact": bool((out[0] == 0).all()),
                       "bitwise_two_runs": torch.equal(out, call())}
                if (launched != 1 or not bool(torch.isfinite(out.float()).all())
                        or not decode_close(rec) or not rec["zero_row_exact"]
                        or not rec["bitwise_two_runs"]):
                    raise RuntimeError(f"K4 with a window disagrees: {rec}")
                worst = max(worst, rec["max_abs_vs_plain"])
                if kind == "int8":
                    nbytes = sum(x.numel() * x.element_size() for x in cache if x is not None)
                    copies = [cache] + [tuple(None if x is None else x.clone() for x in cache)
                                        for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)) - 1)]
                    rec["ms"] = graph_ms([lambda c=c: decode_attention(
                        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3], window=(left, 0))
                        for c in copies])
                    rec["no_window_ms"] = graph_ms([lambda c=c: decode_attention(
                        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3]) for c in copies])
                    rec["plain_ms"] = time_ms(lambda: decode_attention_plain(
                        q, kc, vc, lengths, ks, vs, window_left=left), iters=3, warmup=1)
                    row_bytes = d + 4
                    rec["window_rows"] = _window_rows(lens, left, t)
                    rec.update(bound(rec["window_rows"] * hkv * 2 * row_bytes + 2 * q.numel() * 2))
                    rec["no_window_bound_ms"] = bound(sum(lens) * hkv * 2 * row_bytes
                                                      + 2 * q.numel() * 2)["bound_ms"]
                    times[left, t] = rec
                    del copies
                log("k4_window " + json.dumps(rec))
                del q, cache, kc, vc, ks, vs, out, plain
        torch.cuda.empty_cache()
    pick = times[WINDOW_LEFTS[0], 1]
    return {"window_max_abs_err": worst, "window_ms": pick["ms"],
            "window_no_window_ms": pick["no_window_ms"], "window_bound_ms": pick["bound_ms"],
            "window_plain_ms": pick["plain_ms"]}


def _k10_window(gen) -> dict:
    """K10 over 16 slots up to 1024 tokens (one empty, one full; pages of
    128 in a shuffled pool) with windows (255, 0) and (1023, 0), every page
    kind, T = 1 and 5, against its plain version; int8 pages timed cold
    beside the same call without the window and the in-window bound."""
    b, hq, hkv, d, ps = K10_SLOTS, 32, 8, 128, PAGED16["page_size"]
    pps = K10_MAX_LEN // ps
    pool = b * pps + K10_SPARE_PAGES
    rng = np.random.default_rng(13)
    lens_np = rng.integers(VERIFY_TIMED_T, K10_MAX_LEN + 1, b)
    lens_np[0], lens_np[1] = 0, K10_MAX_LEN
    lens = torch.tensor(lens_np, dtype=torch.int32, device="cuda")
    table = torch.from_numpy(rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)).cuda()
    worst, times = 0.0, {}
    for left in WINDOW_LEFTS:
        for t in (1, VERIFY_TIMED_T):
            for kind in VERIFY_KINDS:
                q = _randn((b, hq, d) if t == 1 else (b, hq, t, d), gen)
                pages = _paged_pool(gen, kind, ps, pool, hkv, d)
                k, v, ks, vs = pages
                call = functools.partial(paged_decode_attention, q, k, v, lens, table,
                                         k_scale_pages=ks, v_scale_pages=vs, pages_per_block=1,
                                         window=(left, 0))
                before = paged_decode_attention.window_launches
                out = call()
                launched = paged_decode_attention.window_launches - before
                plain = paged_decode_attention_plain(q, k, v, lens, table, ks, vs, window_left=left)
                torch.cuda.synchronize()
                rec = {"pages": kind, "T": t, "window": [left, 0], "window_launches": launched,
                       **decode_vs_plain(out, plain, lens_np.tolist()),
                       "zero_row_exact": bool((out[0] == 0).all()),
                       "bitwise_two_runs": torch.equal(out, call())}
                if (launched != 1 or not bool(torch.isfinite(out.float()).all())
                        or not decode_close(rec) or not rec["zero_row_exact"]
                        or not rec["bitwise_two_runs"]):
                    raise RuntimeError(f"K10 with a window disagrees: {rec}")
                worst = max(worst, rec["max_abs_vs_plain"])
                if kind == "int8":
                    nbytes = sum(x.numel() * x.element_size() for x in pages if x is not None)
                    copies = [pages] + [tuple(None if x is None else x.clone() for x in pages)
                                        for _ in range(max(1, math.ceil(COLD_BYTES / nbytes)) - 1)]
                    rec["ms"] = graph_ms([lambda p=p: paged_decode_attention(
                        q, p[0], p[1], lens, table, k_scale_pages=p[2], v_scale_pages=p[3],
                        pages_per_block=1, window=(left, 0)) for p in copies])
                    rec["no_window_ms"] = graph_ms([lambda p=p: paged_decode_attention(
                        q, p[0], p[1], lens, table, k_scale_pages=p[2], v_scale_pages=p[3],
                        pages_per_block=1) for p in copies])
                    rec["plain_ms"] = time_ms(lambda: paged_decode_attention_plain(
                        q, k, v, lens, table, ks, vs, window_left=left), iters=3, warmup=1)
                    row_bytes = d + 4
                    extra = 2 * q.numel() * 2 + table.numel() * 4 + b * 4
                    rec["window_rows"] = _window_rows(lens_np, left, t)
                    rec.update(bound(rec["window_rows"] * hkv * 2 * row_bytes + extra))
                    rec["no_window_bound_ms"] = bound(int(lens_np.sum()) * hkv * 2 * row_bytes
                                                      + extra)["bound_ms"]
                    times[left, t] = rec
                    del copies
                log("k10_window " + json.dumps(rec))
                del q, pages, k, v, ks, vs, out, plain
        torch.cuda.empty_cache()
    pick = times[WINDOW_LEFTS[0], 1]
    return {"window_max_abs_err": worst, "window_ms": pick["ms"],
            "window_no_window_ms": pick["no_window_ms"], "window_bound_ms": pick["bound_ms"],
            "window_plain_ms": pick["plain_ms"]}


def _k9_window(gen) -> dict:
    """K9 at Llama-3-8B's layer (Mistral-7B's is the same), 16 slots /
    1024, ragged lengths, with a window of 256 (window_left 255) against
    its plain version, timed by graph replay beside the same call without
    the window; the bound counts the in-window rows."""
    cfg = llama.mistral_7b()
    e, inter, hq, hkv, d = (cfg.hidden_size, cfg.intermediate_size, cfg.num_q_heads,
                            cfg.num_kv_heads, cfg.head_dim)
    f = cfg.q_dim + 2 * cfg.kv_dim
    layer, nxt, mats = _k9_layer(gen, cfg)
    b, s_max = K9_SHAPES[0]
    left = K9_WINDOW - 1
    rng = np.random.default_rng(19)
    lens = rng.integers(1, s_max + 1, b)
    lens[:3] = [0, 1, s_max]
    kc, ks = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
    vc, vs = quant.dynamically_quantize_int8(_randn((b, hkv, s_max, d), gen, torch.float32), reduction_dim=-1)
    x, q = _randn((b, e), gen), _randn((b, hq, d), gen)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    inactive = torch.zeros(b, dtype=torch.bool, device="cuda")
    ctx = megastep.build_decode_ctx(lengths, inactive, s_max, window_left=left)
    ctx0 = megastep.build_decode_ctx(lengths, inactive, s_max)
    kw = dict(next_attn_norm=nxt["attn_norm"], next_w_qkv=nxt["w_qkv"], eps=cfg.rms_norm_eps)
    before = megastep.fused_decode_layer.window_launches
    got = megastep.fused_decode_layer(x, q, kc, vc, ks, vs, ctx, layer, **kw)
    launched = megastep.fused_decode_layer.window_launches - before
    ref = megastep.fused_decode_layer_plain(x, q, kc, vc, ks, vs, ctx, layer, **kw)
    torch.cuda.synchronize()
    rec = {"B": b, "S": s_max, "window_left": left, "window_launches": launched,
           "rel_vs_plain": max(max_rel(a, r) for a, r in zip(got, ref)),
           "max_abs_vs_plain": max(max_abs(a, r) for a, r in zip(got, ref))}
    if launched != 1 or not rec["rel_vs_plain"] <= QUANT_KERNEL_REL:
        raise RuntimeError(f"K9 with a window disagrees with its plain version: {rec}")
    rec["ms"] = graph_ms(lambda: megastep.fused_decode_layer(x, q, kc, vc, ks, vs, ctx, layer, **kw))
    rec["no_window_ms"] = graph_ms(lambda: megastep.fused_decode_layer(x, q, kc, vc, ks, vs, ctx0,
                                                                       layer, **kw))
    rec["plain_ms"] = graph_ms(lambda: megastep.fused_decode_layer_plain(x, q, kc, vc, ks, vs, ctx,
                                                                         layer, **kw),
                               reps=1, iters=3)
    win_lens = [min(int(n), left + 1) for n in lens]
    macs = cfg.q_dim * e + 3 * e * inter + e * f
    rec.update(bound(_k9_bytes(win_lens, hkv, d, mats, e, f),
                     {"bf16": 2 * b * macs + 4 * hq * d * sum(win_lens)}))
    log("k9_window " + json.dumps(rec))
    del layer, nxt, mats, kc, vc, ks, vs
    torch.cuda.empty_cache()
    return {"window_max_abs_err": rec["max_abs_vs_plain"], "window_ms": rec["ms"],
            "window_no_window_ms": rec["no_window_ms"], "window_bound_ms": rec["bound_ms"],
            "window_plain_ms": rec["plain_ms"]}


def phase_window_kernels(gen) -> dict:
    """The window checks of K1, K2/K3, K4, K9 and K10 (``k1_window``,
    ``k1_window_protocol``, ``k23_window``, ``k4_window``, ``k10_window``,
    ``k9_window`` lines), each against its plain version under its bars and
    timed beside its no-window time.  Returns each kernel's JSON keys."""
    k1 = {}
    for mode in ("head", "token", "bf16"):
        for causal, window, q_off, kv_off in WINDOW_K1:
            rec = _k1_window_case(gen, mode, causal, window, q_off, kv_off)
            k1[mode, causal, tuple(window), q_off] = rec
            torch.cuda.empty_cache()
    proto = _k1_window_protocol(gen)
    pick = k1["head", True, (WINDOW_LEFTS[1], 0), 0]
    k23 = _k23_window(gen)
    return {
        "k1": {"window_max_abs_err": max(r["max_abs_vs_plain"] for r in k1.values()),
               "window_ms": pick["ms"], "window_no_window_ms": pick["no_window_ms"],
               "window_bound_ms": pick["bound_ms"], "window_plain_ms": pick["plain_ms"],
               "window_protocol_ms": proto["fp8_head_ms"],
               "window_protocol_library_ms": proto["library_ms"]},
        "dq": {"window_max_abs_err": k23["dq_max_abs_vs_plain"], "window_ms": k23["dq_ms"],
               "window_no_window_ms": k23["dq_no_window_ms"],
               "window_bound_ms": k23["dq_bound"]["bound_ms"], "window_plain_ms": k23["dq_plain_ms"]},
        "dkv": {"window_max_abs_err": max(k23["dk_max_abs_vs_plain"], k23["dv_max_abs_vs_plain"]),
                "window_ms": k23["dkv_ms"], "window_no_window_ms": k23["dkv_no_window_ms"],
                "window_bound_ms": k23["dkv_bound"]["bound_ms"],
                "window_plain_ms": k23["dkv_plain_ms"]},
        "k4": _k4_window(gen),
        "k10": _k10_window(gen),
        "k9": _k9_window(gen),
    }


def _mistral_kv_bytes(lens, cfg) -> dict:
    """The KV bytes one decode step of slots at these lengths reads over
    every layer (int8 rows and fp32 scales): the rows inside the window,
    the 64-row tiles the kernel fetches (``decode_schedule``), and the whole
    cache."""
    left = cfg.window - 1
    row = cfg.num_kv_heads * 2 * (cfg.head_dim + 4) * cfg.num_layers
    sched = decode_schedule(lens, 1, ROWS_PER_TILE, 1, None, window_left=left)
    fetched = sum(int(n) - f * ROWS_PER_TILE for n, f in zip(lens, sched.first) if n)
    return {"window_rows": _window_rows(lens, left, 1),
            "kv_bytes_per_step_window": _window_rows(lens, left, 1) * row,
            "kv_bytes_per_step_fetched": fetched * row,
            "kv_bytes_per_step_full": int(sum(lens)) * row}


def phase_serve_mistral(params, cfg) -> dict:
    """Mistral-7B's bf16 tree on the slots backend: 4 slots of 8192 rows, an
    int8 cache, 4 greedy requests with prompts of 1000 to 7800 tokens (three
    past the 4096-token window), 64 new tokens a step at a time, then the
    same in graph bursts of 16.  Checks: K1 with the window (4095, 0) in
    every prefill forward, K4 with the window in every decode step, no
    fallback, each prefill's logits within PREFILL_REL_BOUND of SDPA with
    the window, one K4 step within 5% of its plain version, and the burst
    run's tokens equal to the step-at-a-time run's."""
    shape = MISTRAL_SLOTS
    L = cfg.num_layers
    eng = Engine(params, cfg, num_slots=shape["slots"], max_len=shape["max_len"],
                 cache_dtype=torch.int8, device="cuda")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in shape["prompts"]]
    torch.cuda.reset_peak_memory_stats()
    reqs = [eng.submit(p, max_new_tokens=shape["new"]) for p in prompts]
    run = _timed_engine(eng)
    launches, stats = run["launches"], run["stats"]
    mid = [n + shape["new"] // 2 for n in shape["prompts"]]
    rec = {"stats": stats, "launches": launches, "wall_s": run["wall_s"],
           "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_s": (stats["generated_tokens"] - len(reqs)) / run["decode_s"],
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
           "mid_decode_lengths": mid, **_mistral_kv_bytes(mid, cfg)}
    log("serve_mistral " + json.dumps(rec))
    for r in reqs:
        if not r.done or len(r.output) != shape["new"]:
            raise RuntimeError(f"serve_mistral: request {r.id} ended with {len(r.output)} tokens")
    if launches["k1_window"] < L * stats["prefill_forwards"]:
        raise RuntimeError(f"serve_mistral: K1 ran {launches['k1_window']} times with the window "
                           f"for {stats['prefill_forwards']} prefills")
    if launches["k4_window"] < L * stats["decode_steps"]:
        raise RuntimeError(f"serve_mistral: K4 ran {launches['k4_window']} times with the window "
                           f"for {stats['decode_steps']} steps")
    if launches["sdpa_fallback"]:
        raise RuntimeError("serve_mistral: the main path fell back to SDPA")
    _prefill_vs_sdpa("serve_mistral", params, cfg, run["prefills"])
    run["prefills"].clear()
    _slots_k4_vs_plain("serve_mistral", eng, params, seed=22, cfg=cfg, lens=shape["prompts"])
    eager = [list(r.output) for r in reqs]
    reqs = [eng.submit(p, max_new_tokens=shape["new"]) for p in prompts]
    burst = _timed_engine(eng, burst=shape["burst"])
    brec = {"launches": burst["launches"], "backend": dict(eng._backend.stats),
            "burst_ms_per_step": burst["burst_ms_per_step"],
            "burst_tok_s": shape["slots"] * 1e3 / burst["burst_ms_per_step"],
            "tokens_equal_eager": [list(r.output) for r in reqs] == eager}
    log("serve_mistral_burst " + json.dumps(brec))
    if not brec["tokens_equal_eager"]:
        raise RuntimeError("serve_mistral: the burst run's tokens differ from the eager run's")
    total = {k: launches[k] + burst["launches"][k] for k in launches}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_serve_mistral_paged(tree, cfg) -> dict:
    """Mistral-7B's int8 fused tree on the paged backend: 4 slots, pages of
    128, chunks of 1024, the prefix cache, 4 prompts of 5000 tokens sharing
    4096, 33 new tokens in bursts of 16, cold then hot (``_serve_paged``'s
    checks: hot final-chunk logits against cold, cold against SDPA with the
    window, K10 every layer of every step, one K10 step against its plain
    version, a graph burst against eager steps).  Also: every chunk past
    the window ran K1 over the prefix cut to it (kv_offset > 0)."""
    offsets = []
    kernel = backends.flash_attention

    def k1_spy(q, k, v, **kw):
        offsets.append((kw.get("q_offset", 0), kw.get("kv_offset", 0), k.shape[2]))
        return kernel(q, k, v, **kw)

    backends.flash_attention = k1_spy
    try:
        total = _serve_paged("serve_mistral_paged", tree, MISTRAL_PAGED, torch.int8, False,
                             plain_flags={"kernel.qmm": False, "kernel.qmlp": False}, cfg=cfg)
    finally:
        backends.flash_attention = kernel
    cut = sorted({(q, kv, n) for q, kv, n in offsets if kv > 0})
    log(f"serve_mistral_paged k1_cut_prefix (q_offset, kv_offset, K rows)={json.dumps(cut)}")
    if not cut or any(kv != q - (cfg.window - 1) for q, kv, _ in cut):
        raise RuntimeError(f"serve_mistral_paged: no chunk ran K1 over the cut prefix: {cut}")
    if total["k10_window"] <= 0 or total["k1_window"] <= 0:
        raise RuntimeError(f"serve_mistral_paged: window launches {total}")
    return total


def phase_serve_mistral_mega(tree, cfg) -> dict:
    """Mistral-7B's int8 fused tree on 16 slots of 4608 rows: 16 prompts of
    4300 tokens (past the 4096-token window), 48 new tokens in graph bursts
    of 16, every decode step one K9 call a layer with window_left 4095; then
    one K9 step against the unfused step (lean decode + K8) on the same
    cache, lengths 4150 to 4300."""
    shape = MISTRAL_MEGA
    L = cfg.num_layers
    eng = Engine(tree, cfg, num_slots=shape["slots"], max_len=shape["max_len"],
                 cache_dtype=torch.int8, device="cuda")
    backend = eng._backend
    if backend.route(tree) != "mega":
        raise RuntimeError("serve_mistral_mega: the 16-slot int8 step does not route to K9")
    rng = np.random.default_rng(23)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, shape["prompt"]).tolist(),
                       max_new_tokens=shape["new"]) for _ in range(shape["slots"])]
    torch.cuda.reset_peak_memory_stats()
    run = _timed_engine(eng, burst=shape["burst"])
    launches, stats = run["launches"], run["stats"]
    mid = [shape["prompt"] + shape["new"] // 2] * shape["slots"]
    rec = {"stats": stats, "backend": dict(backend.stats), "launches": launches,
           "wall_s": run["wall_s"], "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "burst_ms_per_step": run["burst_ms_per_step"],
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, **_mistral_kv_bytes(mid, cfg)}
    log("serve_mistral_mega " + json.dumps(rec))
    run["prefills"].clear()
    for r in reqs:
        if not r.done or len(r.output) != shape["new"]:
            raise RuntimeError(f"serve_mistral_mega: request {r.id} ended with {len(r.output)} tokens")
    if launches["k9_window"] < L * stats["decode_steps"] or launches["k4"] or launches["k8"]:
        raise RuntimeError(f"serve_mistral_mega: decode launches {launches} for "
                           f"{stats['decode_steps']} steps")
    _mega_vs_unfused(backend, tree, cfg, seed=24, prompt=shape["prompt"], low=shape["prompt"] - 150,
                     label="serve_mistral_mega")
    del eng, backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mistral_train() -> dict:
    """One SGD step of ``mistral_7b(num_layers=4)`` (seeded random bf16
    weights) over 5120 positions, where the 4096-token window bites, through
    the fp8 path (K1, K2 and K3 with the window (4095, 0)); first the
    gradients of the bf16 and fp8 paths against the SDPA path's."""
    cfg = llama.mistral_7b(num_layers=MISTRAL_TRAIN["layers"])
    params = llama.init_params(torch.Generator("cuda").manual_seed(7), cfg, "cuda")
    rng = np.random.default_rng(25)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, MISTRAL_TRAIN["positions"] + 1))).cuda()
    with torch.no_grad():
        plain_loss = float(llama.loss_fn(params, tokens, dataclasses.replace(cfg, attention_impl="sdpa")))
    _, ref = llama.loss_and_grads(params, tokens, dataclasses.replace(cfg, attention_impl="sdpa"))
    ref = _grad_leaves(ref)
    errs = {}
    for impl in ("bf16", "fp8"):
        _, grads = llama.loss_and_grads(params, tokens, dataclasses.replace(cfg, attention_impl=impl))
        errs[impl] = {name: rel_fro(g, ref[name]) for name, g in _grad_leaves(grads).items()}
        del grads
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mistral_train grads layers={cfg.num_layers} positions={MISTRAL_TRAIN['positions']} "
        f"rel_fro_vs_sdpa={json.dumps(errs)} bounds={json.dumps(TRAIN_GRAD_BOUND)}")
    for impl, e in errs.items():
        if not all(x < TRAIN_GRAD_BOUND[impl] for x in e.values()):
            raise RuntimeError(f"mistral_train: {impl} gradients off: {e}")
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, loss = llama.train_step(params, tokens, cfg)
    loss = float(loss)
    torch.cuda.synchronize()
    launches = _train_counts()
    rec = {"loss": loss, "plain_loss": plain_loss, "ms": 1e3 * (time.perf_counter() - t0),
           "launches": launches}
    log("mistral_train step " + json.dumps(rec))
    L = cfg.num_layers
    if not np.isfinite(loss) or not abs(loss - plain_loss) / abs(plain_loss) < LOSS_REL_BOUND:
        raise RuntimeError(f"mistral_train: loss {loss} vs plain {plain_loss}")
    if (launches["k1_window"] < 2 * L or launches["k2_window"] < L or launches["k3_window"] < L
            or launches["sdpa_fallback"]):
        raise RuntimeError(f"mistral_train: launches {launches}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mistral() -> dict:
    """Mistral-7B at full width and depth (``llama.mistral_7b()``, seeded
    random bf16 weights, nothing downloaded): ``serve_mistral`` on the bf16
    tree, then the int8 fused tree's ``serve_mistral_paged`` and
    ``serve_mistral_mega``, then the training check.  Returns the window
    launches of each kernel on these paths."""
    cfg = llama.mistral_7b()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator("cuda").manual_seed(20), cfg, "cuda")
    torch.cuda.synchronize()
    log(f"mistral init_params_s={time.perf_counter() - t0:.3f} weights_GB={_weight_bytes(params) / 1e9:.3f}")
    slots = phase_serve_mistral(params, cfg)
    tree = quantized.fuse_projections(quantized.quantize_params(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paged = phase_serve_mistral_paged(tree, cfg)
    phase_serve_mistral_per_block(tree, cfg)
    mega = phase_serve_mistral_mega(tree, cfg)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_mistral_train()
    return {"k1": slots["k1_window"] + paged["k1_window"] + mega["k1_window"] + train["k1_window"],
            "k2": train["k2_window"], "k3": train["k3_window"], "k4": slots["k4_window"],
            "k9": mega["k9_window"], "k10": paged["k10_window"]}


# ---------------------------------------------------------------------------
# Mixtral-8x7B (MoE) and Hugging Face checkpoints
# ---------------------------------------------------------------------------


def _tests_module(name: str):
    """A helper module of tests/ by path (the fuzz draws and the checkpoint
    writer are shared with the tests)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _moe_layer_check(tree, cfg, gen) -> dict:
    """Layer 0's MoE FFN of the int8 tree at full width, at decode rows (4
    tokens: capacity 8) and prefill rows (1500 tokens: capacity 472): each
    expert product through K5/K6 (one launch an expert, 3 x E a layer)
    against the plain einsum over the dequantized stacks in fp32, within
    QUANT_KERNEL_REL of its largest value; the three products' device time
    by graph replay beside their bound and the plain einsum's time."""
    layer = tree["layers"][0]["moe"]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    recs = []
    for n in MIXTRAL_LAYER_TOKENS:
        x = _randn((n, cfg.hidden_size), gen)
        logits = torch.matmul(x.float(), layer["w_router"])
        gates, experts = moe.router_topk(logits, k)
        cap = moe.expert_capacity(n, e, k, cfg.capacity_factor)
        dispatch_t, _ = moe.make_dispatch_combine(gates, experts, e, cap)
        x_e = torch.einsum("nec,nh->ech", dispatch_t.to(x.dtype), x).contiguous()

        def products():
            gate = quantized.matmul(x_e, layer["w_gate"])
            up = quantized.matmul(x_e, layer["w_up"])
            act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
            return gate, up, act, quantized.matmul(act, layer["w_down"])

        def plain(inp, w):
            return torch.matmul(inp.float(), w["q"].float() * w["s"])

        before = (dict(qmm.route_launches), qmm.quantized_matmul.launches, qmm.quantized_matmul.splitk_launches)
        gate, up, act, down = products()
        torch.cuda.synchronize()
        rec = {"tokens": n, "capacity": cap, "wgmma_launches": qmm.route_launches["wgmma"] - before[0]["wgmma"],
               "k5_launches": qmm.quantized_matmul.launches - before[1],
               "k6_launches": qmm.quantized_matmul.splitk_launches - before[2]}
        for name, got, inp, w in (("w_gate", gate, x_e, layer["w_gate"]), ("w_up", up, x_e, layer["w_up"]),
                                  ("w_down", down, act, layer["w_down"])):
            rec[f"{name}_rel_vs_plain"] = max_rel(got, plain(inp, w))
        with config.patch({"kernel.qmm": False}):
            rec["plain_ms"] = time_ms(products, iters=3, warmup=1)
        rec["ms"] = graph_ms(products, reps=2, iters=5)
        nbytes = sum(_weight_bytes(layer[name]) for name in ("w_gate", "w_up", "w_down"))
        nbytes += 2 * (2 * x_e.numel() + 2 * act.numel() + down.numel())
        rec.update(bound(nbytes, {"bf16": 2.0 * 3 * e * cap * cfg.hidden_size * cfg.intermediate_size}))
        with config.patch({"kernel.qmm": False}):
            ref = moe.moe_ffn(layer, x, num_experts_per_tok=k, capacity_factor=cfg.capacity_factor)
        got = moe.moe_ffn(layer, x, num_experts_per_tok=k, capacity_factor=cfg.capacity_factor)
        rec["moe_ffn_rel_fro_vs_plain"] = rel_fro(got, ref)
        recs.append(rec)
        log("mixtral_moe_layer " + json.dumps(rec))
        if rec["wgmma_launches"] != 3 * e or rec["k5_launches"] + rec["k6_launches"] != 3 * e:
            raise RuntimeError(f"mixtral_moe_layer: {rec['wgmma_launches']} launches for 3 x {e} products")
        if not all(rec[f"{w}_rel_vs_plain"] <= QUANT_KERNEL_REL for w in ("w_gate", "w_up", "w_down")):
            raise RuntimeError(f"mixtral_moe_layer: expert products off the plain einsum: {rec}")
        del x_e, gate, up, act, down, ref, got
        torch.cuda.empty_cache()
    return {"decode": recs[0], "prefill": recs[-1]}


@contextlib.contextmanager
def _moe_routing(recorded: list, replay: bool = False, own_choices: list = None):
    """Record each MoE layer's expert choices in order (``recorded`` gets
    each ``router_topk``'s experts), or replay them: a run then takes the
    recorded experts, its gates the softmax of its own logits at them, so
    capacity and drops follow the recorded run.  A random-weight MoE's
    routing is chaotic: a rounding difference flips a near-tied choice and
    shifts every later token's place in an expert's queue (PERF.md §6,
    Mixtral), so a comparison of numerics holds the choices fixed.
    ``_moe_routing.flips`` counts the tokens whose own choices in the
    replaying run differ, of ``_moe_routing.choices``; ``own_choices``,
    where given, gets the replaying run's own choices."""
    orig = moe.router_topk
    it = iter(list(recorded))

    def recording(logits, k):
        gates, experts = orig(logits, k)
        recorded.append(experts)
        return gates, experts

    def replaying(logits, k):
        experts = next(it)
        own = orig(logits, k)[1]
        if own_choices is not None:
            own_choices.append(own)
        _moe_routing.flips += int((own.sort(-1).values != experts.sort(-1).values).any(-1).sum())
        _moe_routing.choices += experts.shape[0]
        return torch.softmax(logits.gather(-1, experts.long()), dim=-1), experts

    moe.router_topk = replaying if replay else recording
    try:
        yield
    finally:
        moe.router_topk = orig


_moe_routing.flips = 0
_moe_routing.choices = 0


def _prefill_vs_plain_k1(label: str, params, cfg, prefills) -> float:
    """Each served prefill batch again through the kernels (recording the
    expert choices; bit for bit the served logits), then through K1's plain
    version and the plain weight products with those choices
    (``_moe_routing``): every row's last-position logits within
    PREFILL_REL_BOUND of the served ones.  Logs how many of the plain
    run's own choices differ.  Returns the worst relative error."""
    worst = 0.0
    for tokens, last_pos, logits in prefills:
        routing = []
        last = torch.tensor(last_pos, device="cuda")
        with _moe_routing(routing):
            again, _ = llama.forward_prefill(params, tokens, cfg, last_pos=last)
        repeat = bool(torch.equal(again, logits))
        del again
        kernel = dispatch.flash_attention
        dispatch.flash_attention = flash_attention_plain
        _moe_routing.flips = _moe_routing.choices = 0
        try:
            before = _counts()
            with config.patch({"kernel.qmm": False}), _moe_routing(routing, replay=True):
                ref, _ = llama.forward_prefill(params, tokens, cfg, last_pos=last)
            after = _counts()
        finally:
            dispatch.flash_attention = kernel
        if any(after[key] != before[key] for key in ("k1", "k5", "k6")):
            raise RuntimeError(f"{label}: the plain prefill launched a kernel: {before} -> {after}")
        for i, pos in enumerate(last_pos):
            rel = rel_fro(logits[i], ref[i])
            log(f"{label} prefill rows={tuple(tokens.shape)} len={pos + 1} rel_err_vs_plain_k1={rel} "
                f"argmax_agree={bool(logits[i].argmax() == ref[i].argmax())} kernel_repeat_bitwise={repeat} "
                f"plain_own_choices_differing={_moe_routing.flips}/{_moe_routing.choices}")
            if not bool(torch.isfinite(logits[i]).all()) or not repeat:
                raise RuntimeError(f"{label}: prefill logits not finite or not repeatable")
            worst = max(worst, rel)
        del ref
    log(f"{label} prefill worst_rel_err_vs_plain_k1={worst} bound={PREFILL_REL_BOUND}")
    if not worst < PREFILL_REL_BOUND:
        raise RuntimeError(f"{label}: prefill logits off the plain run by {worst}")
    return worst


def _mixtral_step_checks(label: str, eng, tree, cfg) -> None:
    """On the served engine's backend: 4 slots prefilled, one decode step
    through K4 and K5/K6 against the same step through their plain versions
    with the kernel step's expert choices (``_moe_routing``; lengths
    restored between: the step rewrites the same rows), within
    DECODE_K8_REL_BOUND a slot; the served step (its graph) against the
    uncaptured kernel step, bit for bit; then a graph-captured burst
    against eager steps, token for token."""
    backend = eng._backend
    L, e = cfg.num_layers, cfg.num_experts
    rng = np.random.default_rng(31)
    lens = [100, 37, 128, 64]
    tokens = torch.zeros((4, 128), dtype=torch.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
    slots = [0, 1, 2, 3]
    backend.prefill_and_write(eng._prefill_fn, tree, tokens.cuda(), [n - 1 for n in lens], slots, lens, 128)
    saved = [cache.lengths.clone() for cache in backend.caches]
    cur = rng.integers(0, cfg.vocab_size, 4)
    mask = np.ones(4, bool)
    routing = []
    before = _counts()
    with _moe_routing(routing), _uncaptured():
        got = backend.decode(tree, cur, mask, slots)
    torch.cuda.synchronize()
    ran = {key: _counts()[key] - before[key] for key in ("k4", "k5", "k6", "k8", "k9")}
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    kernel = backends.decode_attention
    backends.decode_attention = plain_k4_call
    _moe_routing.flips = _moe_routing.choices = 0
    try:
        before = _counts()
        with config.patch({"kernel.qmm": False}), _moe_routing(routing, replay=True), _uncaptured():
            ref = backend.decode(tree, cur, mask, slots)
        after = _counts()
    finally:
        backends.decode_attention = kernel
    if any(after[key] != before[key] for key in ("k4", "k5", "k6")):
        raise RuntimeError(f"{label}: the plain step launched a kernel: {before} -> {after}")
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    rel = torch.linalg.vector_norm(got - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    agree = (got.argmax(-1) == ref.argmax(-1)).tolist()
    log(f"{label} step_vs_plain launches={json.dumps(ran)} rel_err={rel.tolist()} argmax_agree={agree} "
        f"plain_own_choices_differing={_moe_routing.flips}/{_moe_routing.choices} bound={DECODE_K8_REL_BOUND}")
    # A step: K4 a layer; wq, wk, wv, wo and 3 x E expert products a layer
    # and the LM head through K5/K6; neither K8 nor K9 (MoE runs unfused).
    if ran["k4"] != L or ran["k5"] + ran["k6"] != L * (4 + 3 * e) + 1 or ran["k8"] or ran["k9"]:
        raise RuntimeError(f"{label}: a decode step launched {ran}")
    if not bool(torch.isfinite(got).all()) or not float(rel.max()) < DECODE_K8_REL_BOUND:
        raise RuntimeError(f"{label}: the step is off its plain step by {rel.tolist()}")
    # The kernel step ran uncaptured for its routing hook: the served
    # ``decode`` (its step graph, once captured) from the same state gives
    # its logits bit for bit and launches what it launched.
    before, replays = _counts(), backend.stats["step_replays"]
    again = backend.decode(tree, cur, mask, slots)
    torch.cuda.synchronize()
    again_ran = {key: _counts()[key] - before[key] for key in ran}
    for cache, n in zip(backend.caches, saved):
        cache.lengths.copy_(n)
    equal = bool(torch.equal(again, got))
    log(f"{label} step_graph_vs_uncaptured replayed={backend.stats['step_replays'] - replays} "
        f"logits_equal={equal} launches={json.dumps(again_ran)}")
    if not equal or again_ran != ran:
        raise RuntimeError(f"{label}: the served step differs from the uncaptured one: {again_ran}")
    _burst_vs_eager(backend, tree, seed=32, label=label)
    for slot in slots:
        backend.release(slot)


def phase_serve_mixtral(tree, cfg) -> dict:
    """Mixtral-8x7B's int8 tree on the slots backend: 4 slots of 2048 rows,
    an int8 cache, 6 greedy requests (prompts of 57 to 1500 tokens, 16-32
    new tokens), a step at a time, then the same in graph bursts of 16.
    Checks: K1 every layer of every prefill, K4 every layer of every step,
    every expert product through K5/K6, neither K8 nor K9 nor SDPA; each
    prefill batch's logits against the same batch through K1's plain
    version and the plain products; the burst run's tokens equal to the
    step-at-a-time run's; then the step checks (``_mixtral_step_checks``).
    Logs ms a decode step and prefill tok/s beside the weight-read bound."""
    L, e = cfg.num_layers, cfg.num_experts
    eng = Engine(tree, cfg, num_slots=MIXTRAL_SERVE["slots"], max_len=MIXTRAL_SERVE["max_len"],
                 cache_dtype=torch.int8, device="cuda")
    rng = np.random.default_rng(30)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    new = [int(rng.integers(16, 33)) for _ in prompts]
    torch.cuda.reset_peak_memory_stats()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    run = _timed_engine(eng)
    launches, stats = run["launches"], run["stats"]
    # A step reads every leaf but the embedding table (a row a slot); dense
    # dispatch runs all experts, so every expert stack is read whole.
    step_bytes = _weight_bytes(tree) - _weight_bytes(tree["embed"])
    rec = {"stats": stats, "launches": launches, "wall_s": run["wall_s"],
           "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"], "prefill_ms": run["prefill_ms"],
           "decode_ms_per_step": run["decode_ms_per_step"],
           "decode_tok_s": (stats["generated_tokens"] - len(reqs)) / run["decode_s"],
           "weight_bytes_per_step": step_bytes, "weight_read_bound_ms": 1e3 * step_bytes / HBM_BYTES_S,
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    log("serve_mixtral " + json.dumps(rec))
    for r in reqs:
        if not r.done or len(r.output) != r.max_new_tokens:
            raise RuntimeError(f"serve_mixtral: request {r.id} ended with {len(r.output)} tokens")
    products = L * 3 * e * (stats["prefill_forwards"] + stats["decode_steps"])
    if (launches["k1"] < L * stats["prefill_forwards"] or launches["k4"] < L * stats["decode_steps"]
            or launches["k5"] + launches["k6"] < products or launches["k8"] or launches["k9"]
            or launches["sdpa_fallback"]):
        raise RuntimeError(f"serve_mixtral: launches {launches} for {stats}")
    _prefill_vs_plain_k1("serve_mixtral", tree, cfg, run["prefills"])
    run["prefills"].clear()
    eager = [list(r.output) for r in reqs]
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    burst = _timed_engine(eng, burst=MIXTRAL_SERVE["burst"])
    burst["prefills"].clear()
    brec = {"launches": burst["launches"], "backend": dict(eng._backend.stats),
            "burst_ms_per_step": burst["burst_ms_per_step"],
            "weight_read_bound_ms": 1e3 * step_bytes / HBM_BYTES_S,
            "tokens_equal_eager": [list(r.output) for r in reqs] == eager}
    log("serve_mixtral_burst " + json.dumps(brec))
    if not brec["tokens_equal_eager"]:
        raise RuntimeError("serve_mixtral: the burst run's tokens differ from the eager run's")
    _mixtral_step_checks("serve_mixtral", eng, tree, cfg)
    total = {key: launches[key] + burst["launches"][key] for key in launches}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_serve_mixtral_paged(tree, cfg) -> dict:
    """The same tree on the paged backend (``_serve_paged`` at
    MIXTRAL_PAGED: 4 slots, pages of 128, chunks of 256, prompts sharing a
    prefix, cold then hot, bursts through K10, chunked K1 with q_offset);
    each round's final chunk is held against the same chunk through K1's
    plain version (the same rows, so the same expert capacity)."""
    total = _serve_paged("serve_mixtral_paged", tree, MIXTRAL_PAGED, torch.int8, False,
                         plain_flags={"kernel.qmm": False}, cfg=cfg)
    if total["k10"] <= 0 or total["k1"] <= 0 or total["k5"] + total["k6"] <= 0:
        raise RuntimeError(f"serve_mixtral_paged: launches {total}")
    return total


def phase_mixtral_train() -> dict:
    """``mixtral_8x7b(num_layers=2)`` at full width, seeded bf16 weights,
    batch 1 over 1024 positions, 2 SGD steps through the fp8 path (K1-K3):
    finite losses, the first within LOSS_REL_BOUND of the SDPA path's, and
    in every layer, every expert of each stack (gate, up, down) and its
    router column moved."""
    cfg = llama.mixtral_8x7b(num_layers=MIXTRAL_TRAIN["layers"])
    params = llama.init_params(torch.Generator("cuda").manual_seed(33), cfg, "cuda")
    rng = np.random.default_rng(33)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, MIXTRAL_TRAIN["positions"] + 1))).cuda()
    with torch.no_grad():
        plain_loss = float(llama.loss_fn(params, tokens, dataclasses.replace(cfg, attention_impl="sdpa")))
    before = [{name: layer["moe"][name].clone() for name in ("w_router", "w_gate", "w_up", "w_down")}
              for layer in params["layers"]]
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    steps = []
    for i in range(MIXTRAL_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = llama.train_step(params, tokens, cfg)
        loss = float(loss)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        steps.append({"step": i, "loss": loss, "ms": 1e3 * sec, "tok_s": MIXTRAL_TRAIN["positions"] / sec})
    launches = _train_counts()
    # Per expert: the share of its entries that changed (the router's
    # expert e is its column e, a stack's is its slice [e]).
    moved = [{name: (layer["moe"][name] != old[name]).movedim(-1 if name == "w_router" else 0, 0)
              .flatten(1).float().mean(1).tolist() for name in old}
             for layer, old in zip(params["layers"], before)]
    rec = {"layers": cfg.num_layers, "positions": MIXTRAL_TRAIN["positions"], "steps": steps,
           "plain_loss": plain_loss, "first_loss_rel_err": abs(steps[0]["loss"] - plain_loss) / abs(plain_loss),
           "moved_fraction": moved, "launches": launches, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    log("mixtral_train " + json.dumps(rec))
    L, n = cfg.num_layers, MIXTRAL_TRAIN["steps"]
    if not all(np.isfinite(s["loss"]) for s in steps) or not rec["first_loss_rel_err"] < LOSS_REL_BOUND:
        raise RuntimeError(f"mixtral_train: losses {steps} vs plain {plain_loss}")
    if (launches["k1"] < 2 * L * n or launches["k2"] < L * n or launches["k3"] < L * n
            or launches["sdpa_fallback"]):
        raise RuntimeError(f"mixtral_train: launches {launches}")
    if not all(v > 0 for layer in moved for per_expert in layer.values() for v in per_expert):
        raise RuntimeError(f"mixtral_train: a weight did not move: {moved}")
    del params, before
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_from_hf() -> dict:
    """A Mixtral checkpoint directory at full width and one layer, written
    from seeded tensors by tests/torch_hf_checkpoint.py (``config.json`` as
    ``MixtralConfig`` spells it, one ``model.safetensors`` in transformers'
    key names) in a temporary
    directory, loaded by ``Engine.from_hf(quantize_weights=True)`` on the
    card: the tree equals ``hf.params_from_hf`` over the same tensors in
    memory bit for bit, and the full-precision tree quantized after the
    fact, and the engine serves 2 requests."""
    ckpt = _tests_module("torch_hf_checkpoint")
    cfg = llama.mixtral_8x7b(num_layers=MIXTRAL_HF["layers"])
    sd = ckpt.mixtral_hf_state_dict(cfg, torch.Generator("cuda").manual_seed(34))
    root = tempfile.mkdtemp(prefix="qa_mixtral_hf_")
    try:
        t0 = time.perf_counter()
        ckpt.write_mixtral_checkpoint(root, cfg, sd)
        write_s = time.perf_counter() - t0
        file_gb = os.path.getsize(os.path.join(root, "model.safetensors")) / 1e9
        t0 = time.perf_counter()
        eng = Engine.from_hf(root, quantize_weights=True, num_slots=2, max_len=512, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = hf.params_from_hf(sd, eng.cfg, quantize=True, device="cuda")
        pairs = list(ckpt.tree_pairs(eng.params, ref))
        equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        del ref, pairs
        # Streamed: equal to the full-precision tree quantized after the fact.
        after = quantized.quantize_params(hf.params_from_hf(sd, eng.cfg, device="cuda"))
        streamed = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in ckpt.tree_pairs(eng.params, after))
        leaves = sum(1 for _ in ckpt.tree_pairs(eng.params, after))
        del after
        gc.collect()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(35)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=MIXTRAL_HF["new"])
                for n in MIXTRAL_HF["prompts"]]
        run = _timed_engine(eng)
        run["prefills"].clear()
        rec = {"layers": cfg.num_layers, "file_GB": file_gb, "write_s": write_s, "load_s": load_s,
               "leaves": leaves, "tree_equal_in_memory": equal, "tree_equal_quantized_after": streamed,
               "config_equal": eng.cfg == cfg,
               "outputs": [len(r.output) for r in reqs], "launches": run["launches"]}
        log("from_hf " + json.dumps(rec))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not (equal and streamed and rec["config_equal"]):
        raise RuntimeError(f"from_hf: the loaded tree or config differs: {rec}")
    if any(not r.done or len(r.output) != MIXTRAL_HF["new"] for r in reqs):
        raise RuntimeError(f"from_hf: requests ended with {rec['outputs']}")
    if run["launches"]["k1"] <= 0 or run["launches"]["k4"] <= 0:
        raise RuntimeError(f"from_hf: launches {run['launches']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def phase_mixtral() -> dict:
    """Mixtral-8x7B at full width and depth (``llama.mixtral_8x7b()``,
    seeded random weights, nothing downloaded): the int8 tree drawn and
    quantized matrix by matrix on the card (int8 attention projections and
    expert stacks, fp32 routers), one MoE layer's checks, ``serve_mixtral``
    and ``serve_mixtral_paged`` on it; then ``mixtral_train`` and
    ``from_hf``.  Returns each kernel's launches on these paths."""
    cfg = llama.mixtral_8x7b()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree = quantized.init_quantized_params(torch.Generator("cuda").manual_seed(30), cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"mixtral init_quantized_params_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={_weight_bytes(tree) / 1e9:.3f} allocated_GB={torch.cuda.memory_allocated() / 1e9:.3f}")
    _moe_layer_check(tree, cfg, torch.Generator("cuda").manual_seed(36))
    slots = phase_serve_mixtral(tree, cfg)
    paged = phase_serve_mixtral_paged(tree, cfg)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_mixtral_train()
    from_hf = phase_from_hf()
    runs = (slots, paged, from_hf)
    return {"k1": sum(r["k1"] for r in runs) + train["k1"], "k2": train["k2"], "k3": train["k3"],
            "k4": slots["k4"] + from_hf["k4"], "k5": sum(r["k5"] for r in runs),
            "k6": sum(r["k6"] for r in runs), "k10": paged["k10"]}


def phase_fuzz() -> None:
    """The CPU fuzz's seeded configurations (tests/torch_fuzz_draws.py) on
    the card, FUZZ_SEEDS of each: K1 (with its modes) against its plain
    version on the same inputs (the wrapper on CPU copies) within the
    RMSE bar; the backward (K1, K2, K3 through ``attention_with_vjp``, bf16)
    against the plain backward within GRAD_BAR; K4 over int8, int4 and bf16
    caches within the decode bars."""
    draws = _tests_module("torch_fuzz_draws")
    for seed in range(FUZZ_SEEDS):
        c = draws.forward_case(seed)
        q, k, v, kw = draws.forward_inputs(c, "cuda")
        before = flash_attention.launches
        out = flash_attention(q, k, v, is_causal=c["is_causal"], window=c["window"], **kw)
        launched = flash_attention.launches - before
        cq, ck, cv, ckw = draws.to_cpu((q, k, v, kw))
        plain = flash_attention(cq, ck, cv, is_causal=c["is_causal"], window=c["window"], **ckw)
        rec = {key: c[key] for key in ("seed", "hq", "hkv", "sq", "skv", "d", "dtype", "is_causal", "window",
                                       "mode")}
        rec.update(launches=launched, rmse_vs_plain=rmse(out.cpu(), plain), bar=RMSE_BAR)
        log("fuzz k1 " + json.dumps(rec))
        if launched != 1 or not rec["rmse_vs_plain"] < RMSE_BAR:
            raise RuntimeError(f"fuzz k1: {rec}")
    for seed in range(FUZZ_SEEDS):
        c = draws.backward_case(seed)
        g = torch.Generator("cuda").manual_seed(1000 + seed)
        shapes_ = [(1, c["hq"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"]), (1, c["hkv"], c["sq"], c["d"])]
        inputs = [_randn(s, g) for s in shapes_]
        before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
        grads = []
        for dev_inputs in (inputs, draws.to_cpu(inputs)):
            leaves = [t.clone().requires_grad_(True) for t in dev_inputs]
            out = attention_with_vjp(*leaves, is_causal=c["is_causal"])
            grads.append(torch.autograd.grad((out.float() ** 2).sum(), leaves))
        rec = {**c, "launches": [flash_bwd_dq.launches - before[0], flash_bwd_dkv.launches - before[1]],
               "bar": GRAD_BAR}
        for name, a, b in zip(("dq", "dk", "dv"), *grads):
            rec[f"{name}_rel_vs_plain"] = max_rel(a.cpu(), b)
        log("fuzz k23 " + json.dumps(rec))
        if rec["launches"] != [1, 1] or not all(rec[f"{n}_rel_vs_plain"] < GRAD_BAR for n in ("dq", "dk", "dv")):
            raise RuntimeError(f"fuzz k23: {rec}")
    for seed in range(FUZZ_SEEDS):
        c = draws.decode_case(seed)
        q, kc, vc, lengths, kw = draws.decode_inputs(c, "cuda")
        before = decode_attention.launches
        out = decode_attention(q, kc, vc, lengths, **kw)
        launched = decode_attention.launches - before
        plain = decode_attention(*draws.to_cpu((q, kc, vc, lengths)), **draws.to_cpu(kw))
        rec = {**c, "launches": launched, **decode_vs_plain(out.cpu(), plain, c["lens"])}
        log("fuzz k4 " + json.dumps(rec))
        if launched != 1 or not decode_close(rec):
            raise RuntimeError(f"fuzz k4: {rec}")


# ---------------------------------------------------------------------------
# Per-block quantization (the quantizer kernel and K1's per-block mode), K1's
# tile configurations and the autotuner
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _tiles_forced(tiles: int):
    """K1 runs tile configuration ``tiles`` whatever the autotuner's cache
    says, and no sweep runs (the forced runs leave the cache alone)."""
    orig = flash_mod._k1_tiles
    flash_mod._k1_tiles = lambda *args, **kw: tiles
    try:
        yield
    finally:
        flash_mod._k1_tiles = orig


def _block_quant_bytes(b: int, h: int, s: int, d: int, rows: int, in_bytes: int = 2) -> int:
    """The quantizer's bytes: each element read once (``in_bytes``) and its
    code written once (the row width rounded up to 16), the block and row
    scales written once."""
    return b * h * (s * d * in_bytes + s * shapes.round_up(d, 16) + 4 * shapes.cdiv(s, rows) + 4 * s)


def phase_block_quant(gen) -> dict:
    """The quantizer kernel against ``quant.quantize_block_wise`` on the
    same card tensors, codes and scales bit for bit, at the timed shape,
    D = 96 (zero-padded codes), a ragged S and the protocol shape (D 64,
    128, 256, Q's 1024-row and K's 2048-row blocks); device time by graph
    replay beside the bytes bound and the plain version's time.  Returns
    the kernels line's entry: the protocol's Q + K pair at D = 128."""
    for row in _ptxas("block_(?:amax|cast)_kernel", ("code",)):
        log("block_quant_ptxas " + json.dumps(row))
    protocol = {}
    for b, h, s, d, rows in BLOCK_QUANT_CASES:
        x = _randn((b, h, s, d), gen) * 3
        x[:, :, 0] *= 40  # an outlier row in each head's first block
        codes, scales, row_scales = quant.block_quant(x, rows)
        want, want_scales = quant.quantize_block_wise(x, rows)
        torch.cuda.synchronize()
        rec = {"B": b, "H": h, "S": s, "D": d, "block_rows": rows,
               "codes_equal": torch.equal(codes[..., :d].view(torch.uint8), want.view(torch.uint8)),
               "pad_zero": not bool(codes[..., d:].view(torch.uint8).any()),
               "scales_equal": torch.equal(scales, want_scales),
               "row_scales_equal": torch.equal(row_scales,
                                               quant.expand_block_scales(want_scales, rows, s))}
        del codes, scales, row_scales, want, want_scales
        rec["ms"] = graph_ms(functools.partial(quant.block_quant, x, rows), reps=4, iters=10)
        rec["plain_ms"] = time_ms(functools.partial(quant.quantize_block_wise, x, rows),
                                  iters=3, warmup=1)
        rec.update(bound(_block_quant_bytes(b, h, s, d, rows)))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        log("block_quant " + json.dumps(rec))
        if not all(rec[k] for k in ("codes_equal", "pad_zero", "scales_equal", "row_scales_equal")):
            raise RuntimeError(f"the quantizer kernel disagrees with its plain version: {rec}")
        if (b, s, d) == (16, 8192, 128):
            protocol[rows] = rec
        del x
        torch.cuda.empty_cache()
    q_rec, k_rec = protocol[1024], protocol[2048]
    return {"max_abs_err": 0.0, "ms": q_rec["ms"] + k_rec["ms"],
            "plain_ms": q_rec["plain_ms"] + k_rec["plain_ms"],
            **bound(_block_quant_bytes(16, 16, 8192, 128, 1024)
                    + _block_quant_bytes(16, 16, 8192, 128, 2048)),
            "library_ms": None}


def _graph_replays_equal(fn) -> bool:
    """Two replays of one CUDA graph of ``fn`` give the same bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    equal = torch.equal(first, out)
    del graph
    return equal


def _tiles_vs_plain(call, plain, d: int) -> dict:
    """max|out - plain| of ``call()`` with each of K1's tile configurations
    at width ``d`` forced, by configuration."""
    errs = {}
    for i, pair in enumerate(autotune.K1_TILES[shapes.kernel_width(d)]):
        with _tiles_forced(i):
            errs[str(list(pair))] = max_abs(call(), plain)
    return errs


def _k1_block_case(gen, sq, skv, d, causal, window, q_off, kv_off) -> dict:
    """K1 per-block (the quantizer on Q and K, then K1) at B = 1, 32/8
    heads against its plain version (1/32) and the fp32 oracle (RMSE < 1e-2:
    on the float inputs from 256 query rows, on the quantized inputs below);
    each tile configuration at the width, forced, within 1/32 of the plain
    version and repeatable over two graph replays."""
    q, k, v = _randn((1, 32, sq, d), gen), _randn((1, 8, skv, d), gen), _randn((1, 8, skv, d), gen)
    kw = dict(is_causal=causal, window=window, q_offset=q_off, kv_offset=kv_off)
    out = flash_attention(q, k, v, fused_block_quant=True, **kw)
    plain = flash_attention_plain(q, k, v, None, None, causal, None, False, q_off,
                                  kernel_window(window, causal), kv_off, True)
    keep = keep_mask(sq, skv, causal, window, q_off, kv_off, "cuda")
    seen = keep.any(-1) if keep is not None else torch.ones(sq, dtype=torch.bool, device="cuda")
    bq, bkv = flash_mod.block_sizes(sq, skv, d)
    if sq >= FLOAT_BAR_MIN_SEQ:
        oracle = sdpa_reference(q, k, v, attn_mask=keep, out_dtype=torch.float32)
    else:  # the fp8 format's own error exceeds the bar on few rows: the quantized inputs
        (q8, sq8), (k8, sk8) = quant.quantize_block_wise(q, bq), quant.quantize_block_wise(k, bkv)
        oracle = sdpa_reference(q8, k8, v, attn_mask=keep, out_dtype=torch.float32,
                                scale_q=quant.expand_block_scales(sq8, bq, sq),
                                scale_k=quant.expand_block_scales(sk8, bkv, skv))
    torch.cuda.synchronize()
    rec = {"Sq": sq, "Skv": skv, "D": d, "causal": causal, "window": window, "q_offset": q_off,
           "kv_offset": kv_off, "blocks": [bq, bkv], "max_abs_vs_plain": max_abs(out, plain),
           "rmse_vs_oracle": rmse(out[:, :, seen], oracle[:, :, seen]),
           "oracle_on": "float inputs" if sq >= FLOAT_BAR_MIN_SEQ else "quantized inputs"}
    del oracle
    call = functools.partial(flash_attention, q, k, v, fused_block_quant=True, **kw)
    rec["max_abs_vs_plain_by_tiles"] = _tiles_vs_plain(call, plain, d)
    del plain
    tiles = autotune.K1_TILES[shapes.kernel_width(d)]
    rec["repeatable"] = {}
    for i, pair in enumerate(tiles):
        with _tiles_forced(i):
            rec["repeatable"][str(list(pair))] = _graph_replays_equal(call)
    log("k1_block " + json.dumps(rec))
    if (not bool(torch.isfinite(out).all()) or rec["max_abs_vs_plain"] > KERNEL_VS_PLAIN_ATOL
            or max(rec["max_abs_vs_plain_by_tiles"].values()) > KERNEL_VS_PLAIN_ATOL
            or not rec["rmse_vs_oracle"] < RMSE_BAR or not all(rec["repeatable"].values())):
        raise RuntimeError(f"K1 per-block disagrees: {rec}")
    return rec


def phase_k1_block(gen) -> dict:
    """K1's per-block mode: the k1_block cases, then at the timed shape
    (B = 1, 32/8 heads, S = 1536, D = 128, causal) the whole call, the
    pre-pass (the quantizer on Q and K) and K1 alone by graph replay, and
    the plain version's time.  Returns the K1 entry's per-block keys."""
    for case in K1_BLOCK_CASES:
        _k1_block_case(gen, *case)
    s, d = 1536, 128
    q, k, v = _randn((1, 32, s, d), gen), _randn((1, 8, s, d), gen), _randn((1, 8, s, d), gen)
    bq, bkv = flash_mod.block_sizes(s, s, d)
    call = functools.partial(flash_attention, q, k, v, fused_block_quant=True, is_causal=True)
    call()  # the tile sweep of this shape class, untimed
    q8, _, rq = quant.block_quant(q, bq)
    k8, _, rk = quant.block_quant(k, bkv)
    key = flash_mod._tile_key(q, k, None, True, True, None)
    tiles = autotune.K1_TILES[shapes.kernel_width(d)].index(autotune.lookup(key) or
                                                             autotune.K1_TILES[128][0])
    rec = {"B": 1, "Hq": 32, "Hkv": 8, "S": s, "D": d, "blocks": [bq, bkv],
           "tiles": list(autotune.K1_TILES[128][tiles]), "ms": graph_ms(call),
           "prepass_ms": graph_ms(lambda: (quant.block_quant(q, bq), quant.block_quant(k, bkv)))}
    with _tiles_forced(tiles):
        rec["k1_ms"] = graph_ms(functools.partial(flash_attention, q8, k8, v, scale_q=rq,
                                                  scale_k=rk, is_causal=True))
    rec["prepass_share"] = rec["prepass_ms"] / rec["ms"]
    rec["plain_ms"] = time_ms(lambda: flash_attention_plain(
        q, k, v, is_causal=True, fused_block_quant=True), iters=5)
    rec["kernel_tflops"] = 4 * 32 * _visible_pairs(s, s, True) * d / rec["ms"] / 1e9
    log("k1_block_timing " + json.dumps(rec))
    return {"per_block_ms": rec["ms"], "per_block_prepass_ms": rec["prepass_ms"],
            "per_block_k1_ms": rec["k1_ms"], "per_block_plain_ms": rec["plain_ms"]}


def document_mask(n: int, doc_granules: int) -> np.ndarray:
    """Packed-document block-diagonal granule mask (sparse_bench.py:51-57)."""
    bm = np.zeros((n, n), bool)
    for s in range(0, n, doc_granules):
        bm[s:s + doc_granules, s:s + doc_granules] = True
    return bm


def local_global_mask(n: int, local: int, n_global: int) -> np.ndarray:
    """Causal sliding window of granules plus global columns (sparse_bench.py:60-65)."""
    r = np.arange(n)
    bm = (r[:, None] >= r[None, :]) & (r[:, None] - r[None, :] < local)
    bm[:, :n_global] = True
    return bm


def random_mask(n: int, density: float) -> np.ndarray:
    """The sparse benchmark's random mask, the diagonal kept (sparse_bench.py:110-112)."""
    bm = np.random.RandomState(0).rand(n, n) < density
    bm[np.arange(n), np.arange(n)] = True
    return bm


def document_ids(rng, b: int, s: int, lo: int, hi: int) -> torch.Tensor:
    """(b, s) int32 segment ids of seeded documents of lo..hi tokens summing to s."""
    rows = []
    for _ in range(b):
        lens, left = [], s
        while left > hi:
            n = int(rng.randint(lo, min(hi, left - lo) + 1))
            lens.append(n)
            left -= n
        lens.append(left)
        rows.append(np.repeat(np.arange(len(lens)), lens))
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def _flex_ms(q, k, v, mask_mod, b) -> "tuple[float | None, str | None]":
    """``torch.compile``d ``flex_attention`` with the BlockMask of
    ``mask_mod`` (128 x 128 blocks): a yardstick, used nowhere in the port.
    (None, reason) where it does not compile or run here."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
        s = q.shape[2]
        block = create_block_mask(mask_mod, b, None, s, s, device="cuda", BLOCK_SIZE=128)
        flex = torch.compile(flex_attention, dynamic=False)
        t0 = time.perf_counter()
        flex(q, k, v, block_mask=block)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ms = time_ms(lambda: flex(q, k, v, block_mask=block), iters=5, warmup=1)
        log(f"k1_modes flex compile_s={compile_s}")
        return ms, None
    except Exception as e:  # noqa: BLE001 - the yardstick is optional; the kernel is not
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160] if str(e) else ''}"


def _efficient_sdpa_ms(q, k, v, keep) -> "tuple[float | None, str | None]":
    """SDPA's memory-efficient back end with the expanded boolean mask."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = keep if keep.ndim == 4 else keep[None, None]
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), iters=3, warmup=1), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:160]


def _k1_mode_case(label: str, call, cut_args, cut_kw, keep, qk_kind: str, nbytes: int,
                  library) -> dict:
    """One mode case: ``call()`` (the entry point on the full tensors) timed
    by graph replay with its launch count, one batch row and two heads
    (``cut_args`` / ``cut_kw``, the plain version's arguments) against the
    fp32 oracle (RMSE < 1e-2) and the plain version (1/32), the bound from
    the (query, key) pairs ``keep`` leaves a head (times the heads), and
    the library calls ``library`` (name -> (ms, refusal))."""
    before = flash_attention.launches
    out = call()
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    q, k, v = cut_args
    plain = flash_attention_plain(*cut_args, **cut_kw)
    oracle_kw = {key: t for key, t in cut_kw.items()
                 if key in ("scale_q", "scale_k", "is_causal")}
    v_f = quant.dequantize(v, cut_kw["scale_v"], axis=-2) if "scale_v" in cut_kw else v
    mask = flash_mod.keep_mask(q.shape[2], k.shape[2], cut_kw.get("is_causal", False), None, 0, 0,
                               "cuda", cut_kw.get("q_segment_ids"), cut_kw.get("kv_segment_ids"),
                               cut_kw.get("block_mask"))
    oracle = sdpa_reference(q, k, v_f, attn_mask=mask, out_dtype=torch.float32,
                            **{key: t for key, t in oracle_kw.items() if key != "is_causal"})
    b, hq, s, d = out.shape
    cut = out[:q.shape[0], :q.shape[1]]
    pairs = int(keep.sum()) * hq * (b if keep.ndim == 2 else 1)
    rec = {"case": label, "B": b, "H": hq, "S": s, "D": d, "launches": launches,
           "density": pairs / (b * hq * s * s), "pairs": pairs,
           "max_abs_vs_plain": max_abs(cut, plain), "rmse_vs_oracle": rmse(cut, oracle),
           "ms": graph_ms(call, reps=4, iters=5)}
    del plain, oracle, mask
    rec.update(bound(nbytes, {qk_kind: 2 * pairs * d, "bf16": 2 * pairs * d}) if qk_kind != "bf16"
               else bound(nbytes, {"bf16": 4 * pairs * d}))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["active_tflops"] = 4 * pairs * d / rec["ms"] / 1e9
    for name, (ms, why) in library.items():
        rec[f"{name}_ms"] = ms
        if why:
            rec[f"{name}_refused"] = why
    log("k1_modes " + json.dumps(rec))
    if (launches != 1 or not bool(torch.isfinite(out).all())
            or rec["max_abs_vs_plain"] > KERNEL_VS_PLAIN_ATOL or not rec["rmse_vs_oracle"] < RMSE_BAR):
        raise RuntimeError(f"K1 disagrees in mode {label}: {rec}")
    return rec


def _k1_modes_zero_rows(gen) -> None:
    """Rows whose segment matches no key and granule rows with no active
    granule come out as exact zeros; the other rows match the plain version."""
    q, k, v = _randn((2, 8, 2048, 128), gen), _randn((2, 2, 2048, 128), gen), _randn((2, 2, 2048, 128), gen)
    ids = torch.zeros((2, 2048), dtype=torch.int32, device="cuda")
    ids[:, 1024:] = 1
    q_ids = ids.clone()
    q_ids[:, 100:300] = 5  # matches no key
    bm = torch.ones((16, 16), dtype=torch.bool, device="cuda")
    bm[3] = False  # rows 384-511 see no key
    cases = {"segments": ({"q_segment_ids": q_ids, "kv_segment_ids": ids}, slice(100, 300)),
             "block_mask": ({"block_mask": bm}, slice(384, 512))}
    for name, (kw, dead) in cases.items():
        for causal in (True, False):
            out = dispatch.attention(q, k, v, is_causal=causal, **kw)
            plain = flash_attention_plain(q, k, v, is_causal=causal, **kw)
            torch.cuda.synchronize()
            rec = {"case": name, "causal": causal, "dead_rows_zero": not bool(out[:, :, dead].any()),
                   "max_abs_vs_plain": max_abs(out, plain)}
            log("k1_modes_zero_rows " + json.dumps(rec))
            if not rec["dead_rows_zero"] or rec["max_abs_vs_plain"] > KERNEL_VS_PLAIN_ATOL:
                raise RuntimeError(f"K1's rows that see no key are not zeros: {rec}")
            del out, plain


def phase_k1_modes(gen) -> dict:
    """K1's modes at the JAX package's sparse benchmark (K1_MODES) through
    ``attn_func``: dense non-causal, the block masks "documents",
    "local+global" and "random", the documents again as causal segment
    ids over ragged lengths; int8 V at K1_INT8_V through ``flash_attention``
    (int8 head-wise Q/K, and e4m3 head-wise Q/K). Each case's device time
    by graph replay beside its bound and the library calls (SDPA's
    memory-efficient back end with the expanded mask, flex_attention where
    it compiles, SDPA over the dequantized V); a graph-captured block-mask
    call against the eager one, bit for bit; rows that see no key.  The
    launch counts of one eager call of each case (counts reset just before,
    read just after) are the kernels line's ``launches_segments``,
    ``launches_block_mask`` and ``launches_int8_v``."""
    from quantumattention_tpu_torch import attn_func

    for row in _ptxas("flash_fwd_modes_kernel", ("W", "code")):
        log("k1_modes_ptxas " + json.dumps(row))
    b, h, s, d = (K1_MODES[key] for key in ("B", "H", "S", "D"))
    n = s // flash_mod.MASK_GRANULE
    q, k, v = (_randn((b, h, s, d), gen) for _ in range(3))
    masks = {"documents": document_mask(n, K1_MODES["doc"] // flash_mod.MASK_GRANULE),
             "local+global": local_global_mask(n, K1_MODES["local"], K1_MODES["global"]),
             "random": random_mask(n, K1_MODES["density"])}
    masks = {name: torch.from_numpy(bm).cuda() for name, bm in masks.items()}
    ids = document_ids(np.random.RandomState(1), b, s, K1_MODES["doc_min"], K1_MODES["doc_max"]).cuda()
    v8, sv = quant.quantize_channel_wise(v, torch.int8)
    bi, hi, s8, d8 = (K1_INT8_V[key] for key in ("B", "H", "S", "D"))
    qi, ki, vi = (_randn((bi, hi, s8, d8), gen) for _ in range(3))
    vi8, svi = quant.quantize_channel_wise(vi, torch.int8)
    int8_qk = [quant.quantize_head_wise(t, torch.int8) for t in (qi, ki)]
    e4m3_qk = [quant.quantize_head_wise(t, torch.float8_e4m3fn) for t in (qi, ki)]
    int8_kw = lambda qk: {"scale_q": qk[0][1], "scale_k": qk[1][1], "scale_v": svi}  # noqa: E731
    # The path a user calls, once each with the counts at 0: K1's launches in its modes.
    _reset_counts()
    for bm in masks.values():
        attn_func(q, k, v, block_mask=bm)
    attn_func(q, k, v, is_causal=True, q_segment_ids=ids, kv_segment_ids=ids)
    for qk in (int8_qk, e4m3_qk):
        flash_attention(qk[0][0], qk[1][0], vi8, is_causal=True, **int8_kw(qk))
    torch.cuda.synchronize()
    counts = _counts()
    log("k1_modes launches " + json.dumps(counts))
    cut = lambda t: t[:1, :2]  # noqa: E731
    bf16_bytes = 4 * b * h * s * d * 2
    recs = {}
    ones = torch.ones((s, s), dtype=torch.bool, device="cuda")
    recs["dense"] = _k1_mode_case(
        "dense", functools.partial(attn_func, q, k, v), (cut(q), cut(k), cut(v)), {}, ones, "bf16",
        bf16_bytes, {"sdpa_flash": _sdpa_ms(q, k, v, False)})
    del ones
    for name, bm in masks.items():
        keep = flash_mod.granule_keep(bm, s, s)
        library = {"sdpa_efficient_mask": _efficient_sdpa_ms(q, k, v, keep)}
        grid = bm
        library["flex"] = _flex_ms(q, k, v, lambda bb, hh, qi_, ki_: grid[qi_ // 128, ki_ // 128], None)
        recs[name] = _k1_mode_case(
            name, functools.partial(attn_func, q, k, v, block_mask=bm), (cut(q), cut(k), cut(v)),
            {"block_mask": bm}, keep, "bf16", bf16_bytes + bm.numel(), library)
        rows, cols = autotune.K1_TILES[shapes.kernel_width(d)][0]
        recs[name]["table_ms"] = graph_ms(functools.partial(
            flash_mod.block_table, bm, s, s, rows, cols, False, None), reps=4, iters=5)
        log("k1_modes table " + json.dumps({"case": name, "ms": recs[name]["table_ms"]}))
        del keep
        torch.cuda.empty_cache()
    keep = flash_mod.keep_mask(s, s, True, None, 0, 0, "cuda", ids, ids)
    library = {"sdpa_efficient_mask": _efficient_sdpa_ms(q, k, v, keep),
               "flex": _flex_ms(q, k, v, lambda bb, hh, qi_, ki_: (ids[bb, qi_] == ids[bb, ki_]) & (qi_ >= ki_), b)}
    recs["segments"] = _k1_mode_case(
        "segments", functools.partial(attn_func, q, k, v, is_causal=True, q_segment_ids=ids,
                                      kv_segment_ids=ids),
        (cut(q), cut(k), cut(v)), {"is_causal": True, "q_segment_ids": ids[:1], "kv_segment_ids": ids[:1]},
        keep, "bf16", bf16_bytes + ids.numel() * 8, library)
    del keep
    equal = _graph_equal(functools.partial(attn_func, q, k, v, block_mask=masks["documents"]))
    log("k1_modes graph_replay_equal " + json.dumps({"case": "documents", "equal": equal}))
    if not equal:
        raise RuntimeError("a graph-captured block-mask call differs from the eager call")
    torch.cuda.empty_cache()
    causal = torch.tril(torch.ones((s8, s8), dtype=torch.bool, device="cuda"))
    vi_deq = quant.dequantize(vi8, svi, axis=-2).to(torch.bfloat16)
    for name, qk in (("int8_v_int8_qk", int8_qk), ("int8_v_e4m3_qk", e4m3_qk)):
        kw = int8_kw(qk)
        cut_kw = {"is_causal": True, **{key: cut(t) for key, t in kw.items()}}
        nbytes = bi * hi * s8 * d8 * (1 + 1 + 1 + 2) + 4 * (2 * bi * hi + bi * hi * d8)
        recs[name] = _k1_mode_case(
            name, functools.partial(flash_attention, qk[0][0], qk[1][0], vi8, is_causal=True, **kw),
            (cut(qk[0][0]), cut(qk[1][0]), cut(vi8)), cut_kw, causal, "fp8", nbytes,
            {"sdpa_flash_dequantized_v": _sdpa_ms(qi, ki, vi_deq, True)})
    del causal, vi_deq
    _k1_modes_zero_rows(gen)
    del q, k, v, v8, sv, qi, ki, vi, vi8, int8_qk, e4m3_qk
    torch.cuda.empty_cache()
    doc, dense = recs["documents"]["ms"], recs["dense"]["ms"]
    log("k1_modes summary " + json.dumps({"documents_over_dense": doc / dense,
                                          "active_tflops": {k_: r["active_tflops"] for k_, r in recs.items()}}))
    if not doc < dense / 2:
        raise RuntimeError(f"the documents mask (density 1/8) takes {doc} ms against dense {dense}")
    return {"launches_segments": counts["k1_segments"], "launches_block_mask": counts["k1_block_mask"],
            "launches_int8_v": counts["k1_int8_v"],
            "modes": {name: {key: r[key] for key in ("ms", "bound_ms", "bound_by", "density",
                                                     "max_abs_vs_plain", "rmse_vs_oracle")}
                      | {key: r[key] for key in r if key.endswith("_ms") and key not in ("ms", "bound_ms")}
                      for name, r in recs.items()}}


def _sdpa_ms(q, k, v, causal: bool) -> "tuple[float | None, str | None]":
    """bf16 SDPA's flash back end (a yardstick)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), iters=3, warmup=1), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:160]


def phase_k1_dense_ab(gen) -> None:
    """Dense K1 at PERF.md's timed shape (B = 1, 32/8 heads, S = 1536,
    D = 128, causal, e4m3 head-wise, and bf16) by graph replay, with the
    ptxas registers and spills of each K1 instantiation: the numbers an
    earlier tree of the port is compared on (``--k1-dense-only``)."""
    for row in _ptxas("flash_fwd_kernel", ("W", "code", "tiles")):
        log("k1_ptxas " + json.dumps(row))
    for row in _ptxas("flash_fwd_modes_kernel", ("W", "code")):
        log("k1_modes_ptxas " + json.dumps(row))
    for mode in ("head", "bf16"):
        args, scales, _ = _k1_inputs(1, 1536, mode, 128, gen)
        fn = functools.partial(flash_attention, *args, is_causal=True, **scales)
        rec = {"mode": mode, "ms": [graph_ms(fn) for _ in range(5)]}
        rec["median_ms"] = sorted(rec["ms"])[2]
        log("k1_dense " + json.dumps(rec))
        del args, scales, fn


def phase_autotune(gen) -> None:
    """The autotuner on the card: for K1 at AUTOTUNE_SHAPES each tile
    configuration's time and the winner (per-block, bf16 and head-wise
    e4m3 kinds), each configuration forced within 1/32 of the plain version
    (on two heads of the first batch row where B > 1: every head is its own
    CTAs, and the plain version's logits at full size would not fit), the
    ptxas registers and spills of configuration 1; for
    "auto" each path's time, the pruned ones and the winner; a second call
    of each shape class times nothing (the ``timed`` counter); a call
    inside a graph capture sweeps nothing."""
    for row in _ptxas("flash_fwd_kernel", ("W", "code", "tiles")):
        if row["tiles"] == 1:
            log("autotune k1_config1_ptxas " + json.dumps(row))
    for b, hq, hkv, s, d in AUTOTUNE_SHAPES:
        q, k, v = _randn((b, hq, s, d), gen), _randn((b, hkv, s, d), gen), _randn((b, hkv, s, d), gen)
        (qh, sqh), (kh, skh) = (quant.quantize_head_wise(t, torch.float8_e4m3fn) for t in (q, k))
        calls = {
            "flash-block": lambda: flash_attention(q, k, v, fused_block_quant=True, is_causal=True),
            "flash": lambda: flash_attention(q, k, v, is_causal=True),
            "flash-q2": lambda: flash_attention(qh, kh, v, scale_q=sqh, scale_k=skh, is_causal=True),
        }
        n = slice(None) if b == 1 else slice(0, 2)
        assert b == 1 or hq == hkv, "heads are sliced only without GQA"
        q1, k1, v1, qh1, kh1 = (t[n, n].contiguous() for t in (q, k, v, qh, kh))
        sqh1, skh1 = sqh[n, n].contiguous(), skh[n, n].contiguous()
        checks_ = {
            "flash-block": (lambda: flash_attention(q1, k1, v1, fused_block_quant=True, is_causal=True),
                            lambda: flash_attention_plain(q1, k1, v1, is_causal=True,
                                                          fused_block_quant=True)),
            "flash": (lambda: flash_attention(q1, k1, v1, is_causal=True),
                      lambda: flash_attention_plain(q1, k1, v1, is_causal=True)),
            "flash-q2": (lambda: flash_attention(qh1, kh1, v1, scale_q=sqh1, scale_k=skh1,
                                                 is_causal=True),
                         lambda: flash_attention_plain(qh1, kh1, v1, sqh1, skh1, is_causal=True)),
        }
        for kind, fn in calls.items():
            key = autotune.shape_key(kind, b, hq, hkv, s, s, d, True, q.dtype if kind != "flash-q2"
                                     else qh.dtype, q.device)
            with autotune.tuning():
                fn()
            timed = autotune.timed
            with autotune.tuning():
                fn()
            torch.cuda.synchronize()
            rec = {"kind": kind, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                   "times_s": autotune.last_sweeps.get(key), "winner": autotune.lookup(key),
                   "second_call_timed": autotune.timed - timed}
            call, plain_call = checks_[kind]
            rec["max_abs_vs_plain_by_tiles"] = _tiles_vs_plain(call, plain_call(), d)
            log("autotune k1 " + json.dumps(rec))
            if rec["second_call_timed"] or rec["winner"] is None:
                raise RuntimeError(f"K1's tile sweep did not cache its winner: {rec}")
            if max(rec["max_abs_vs_plain_by_tiles"].values()) > KERNEL_VS_PLAIN_ATOL:
                raise RuntimeError(f"a K1 tile configuration disagrees with its plain version: {rec}")
        key = autotune.shape_key("path", b, hq, hkv, s, s, d, True, q.dtype, q.device)
        dispatch.fp8_attention(q, k, v, is_causal=True, scaling_method="auto")
        timed = autotune.timed
        dispatch.fp8_attention(q, k, v, is_causal=True, scaling_method="auto")
        torch.cuda.synchronize()
        rec = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "times_s": autotune.last_sweeps.get(key),
               "winner": autotune.lookup_value(key), "second_call_timed": autotune.timed - timed,
               "hits": autotune.hits}
        log("autotune auto " + json.dumps(rec))
        if rec["second_call_timed"] or rec["winner"] not in dispatch.AUTO_PATHS:
            raise RuntimeError(f"the path sweep did not cache its winner: {rec}")
        del q, k, v, qh, kh, q1, k1, v1, qh1, kh1
        torch.cuda.empty_cache()
    # A call inside a graph capture sweeps nothing and takes the defaults.
    q, k, v = _randn((1, 32, 700, 128), gen), _randn((1, 8, 700, 128), gen), _randn((1, 8, 700, 128), gen)
    flash_attention(q[:, :, :64], k[:, :, :64], v[:, :, :64], fused_block_quant=True)  # warm
    sweeps, misses = autotune.sweeps, autotune.misses_in_capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        out = dispatch.fp8_attention(q, k, v, is_causal=True, scaling_method="auto")
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    with _tiles_forced(0):
        want = flash_attention(q, k, v, fused_block_quant=True, is_causal=True)
    rec = {"sweeps_in_capture": autotune.sweeps - sweeps,
           "misses_in_capture": autotune.misses_in_capture - misses,
           "output_is_default_path": torch.equal(out, want)}
    log("autotune capture " + json.dumps(rec))
    if rec["sweeps_in_capture"] or not rec["misses_in_capture"] or not rec["output_is_default_path"]:
        raise RuntimeError(f"a sweep ran under graph capture: {rec}")
    del graph


def phase_serve_per_block(params) -> dict:
    """The engine phase's tree, slots and prompts with ``scaling_method``
    "head-wise" (the default, again), "per-block" and "auto": each served
    once to run its sweeps and first-call costs (untimed), then again with
    the launch counts reset (the timed run may sweep nothing); prefill
    logits against plain attention (``serve``'s checks; the engine phase
    holds head-wise's), prefill tokens/s beside head-wise's second run.
    Returns the per-block run's launches."""
    base = llama.llama3_8b()
    out = {}
    for method, label in (("head-wise", "serve_head_wise"), ("per-block", "serve_per_block"),
                          ("auto", "serve_auto")):
        cfg = dataclasses.replace(base, scaling_method=method)
        serve(label + "_sweeps", params, SERVE_PROMPTS, seed=0, cfg=cfg, check=False)
        timed = autotune.timed
        _, launches, _ = serve(label, params, SERVE_PROMPTS, seed=0, cfg=cfg,
                               check=method != "head-wise")
        rec = {"scaling_method": method, "prefill_tok_s": SERVE_RECS[label]["prefill_tok_s"],
               "head_wise_prefill_tok_s": SERVE_RECS["serve_head_wise"]["prefill_tok_s"],
               "block_quant": launches["block_quant"], "sdpa_fallback": launches["sdpa_fallback"],
               "timed_in_served_run": autotune.timed - timed}
        if method == "auto":
            rec["winners"] = _auto_winners()
        log(f"{label}_summary " + json.dumps(rec))
        if rec["timed_in_served_run"]:
            raise RuntimeError(f"{label}: the served run swept: {rec}")
        if method == "per-block" and launches["block_quant"] < 2 * base.num_layers:
            raise RuntimeError(f"{label}: the quantizer ran {launches['block_quant']} times")
        out[method] = launches
    _prefill_by_method(params, base)
    return out["per-block"]


def phase_serve_order(params) -> None:
    """``serve_per_block``'s runs in another order in one process
    (``--serve-order-only``): per-block first (its K1 tile sweeps, then a
    run with none), head-wise twice, then per-block, head-wise and
    per-block again.  Each ``serve_order_*`` line holds the host-timed
    prefill tokens/s, each prefill's ms and the host counters read around
    the run (``_host_stats``), to tell an order effect from the method."""
    base = llama.llama3_8b()
    order = ("per-block", "per-block", "head-wise", "head-wise", "per-block", "head-wise",
             "per-block")
    for i, method in enumerate(order):
        cfg = dataclasses.replace(base, scaling_method=method)
        serve(f"serve_order_{i}_{method}", params, SERVE_PROMPTS, seed=0, cfg=cfg, check=False)


def _prefill_by_method(params, base) -> None:
    """One prefill forward of the longest serving prompt (1500 tokens) with
    each scaling method, by CUDA events over 3 forwards after a warm-up, in
    two rounds of opposite order (the serving runs' host-timed prefill
    tokens/s spread from call to call)."""
    rng = np.random.default_rng(3)
    n = max(SERVE_PROMPTS)
    tokens = torch.from_numpy(rng.integers(0, base.vocab_size, (1, n))).to("cuda")
    last = torch.tensor([n - 1], device="cuda")
    methods = ["head-wise", "per-block", "auto"]
    rec, timed = {m: [] for m in methods}, autotune.timed
    for order in (methods, methods[::-1]):
        for method in order:
            cfg = dataclasses.replace(base, scaling_method=method)
            rec[method].append(time_ms(lambda: llama.forward_prefill(params, tokens, cfg, last_pos=last),
                                       iters=3, warmup=1))
    log("serve_prefill_forward " + json.dumps({"tokens": n, "ms": rec,
                                               "timed_candidates": autotune.timed - timed}))


def phase_train_per_block(params) -> dict:
    """One training step of the train phase's model with
    ``scaling_method="per-block"``: 4-layer gradients against plain
    attention's (the fp8 bar), the first loss against the plain path's,
    the quantizer, K1, K2 and K3 launched."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama3_8b(scaling_method="per-block")
    L = cfg.num_layers
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_POSITIONS + 1))).to("cuda")
    with torch.no_grad():
        plain_loss = float(llama.loss_fn(params, tokens, llama.llama3_8b(attention_impl="sdpa")))
    ref = _checked_grads(params, tokens, "sdpa")
    grads = _checked_grads(params, tokens, "fp8", scaling_method="per-block")
    errs = {name: rel_fro(g, ref[name]) for name, g in grads.items()}
    del grads, ref
    _reset_train_counts()
    quant.block_quant.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = llama.train_step(params, tokens, cfg)
    loss = float(loss)
    torch.cuda.synchronize()
    launches = {**_train_counts(), "block_quant": quant.block_quant.launches}
    rec = {"layers": L, "positions": TRAIN_POSITIONS, "loss": loss, "plain_loss": plain_loss,
           "first_loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
           "ms": 1e3 * (time.perf_counter() - t0), "grad_rel_fro_vs_plain": errs,
           "launches": launches}
    log("train_per_block " + json.dumps(rec))
    if not all(e < TRAIN_GRAD_BOUND["fp8"] for e in errs.values()):
        raise RuntimeError(f"per-block gradients off: {errs}")
    if not np.isfinite(loss) or not rec["first_loss_rel_err"] < LOSS_REL_BOUND:
        raise RuntimeError(f"per-block training loss {loss} vs plain {plain_loss}")
    if launches["k2"] < L or launches["k3"] < L or launches["block_quant"] < 2 * L:
        raise RuntimeError(f"per-block training launches: {launches}")
    if launches["sdpa_fallback"]:
        raise RuntimeError("per-block training fell back to SDPA")
    return launches


def phase_serve_mistral_per_block(tree, cfg) -> dict:
    """``serve_mistral_paged``'s geometry (chunks of 1024 over the prefix
    cut to the window, kv_offset) once with ``scaling_method="per-block"``:
    every chunk quantizes its Q and gathered K per block.  The autotuner is
    off here, so no sweep lands in the served run.  ``_serve_paged``'s
    checks, logits against plain attention among them."""
    with config.patch({"kernel.autotune": False}):
        total = _serve_paged("serve_mistral_per_block", tree, MISTRAL_PAGED, torch.int8, False,
                             plain_flags={"kernel.qmm": False, "kernel.qmlp": False},
                             cfg=dataclasses.replace(cfg, scaling_method="per-block"))
    if total["block_quant"] <= 0 or total["k1_window"] <= 0:
        raise RuntimeError(f"serve_mistral_per_block: launches {total}")
    return total


# ---------------------------------------------------------------------------
# The parallel layer: four ranks sharing the card over gloo
# ---------------------------------------------------------------------------

#: The mesh phase's world: four ranks on the one card (NCCL refuses two
#: ranks on one device, so the group is gloo and every collective is staged
#: through host memory); each rank reports within ``timeout_s``.
PAR = {"world": 4, "timeout_s": 900}
#: Attention cases, all causal: (function, inputs, scaling, window).  The
#: inputs are the original protocol's D = 128 cell (bench.py:1-5: B = 16,
#: H = 16, S = 8192) or Llama-3-8B's heads (32/8) at B = 1, S = 8192.
PAR_ATTN = {
    "ring_bf16": ("ring", "protocol", None, None),
    "ring_fp8_head": ("ring", "protocol", "head", None),
    "ring_fp8_token": ("ring", "protocol", "token", None),
    "ring_window": ("ring", "llama", None, (4095, 0)),
    "ulysses_bf16": ("ulysses", "protocol", None, None),
    "head_parallel_fp8": ("head", "llama", "head", None),
}
PAR_SHAPES = {"protocol": (16, 16, 16, 8192, 128), "llama": (1, 32, 8, 8192, 128)}
#: Pipeline: 4 stages of one Llama-3-8B decoder layer each (bf16, K1
#: causal), 4 microbatches of (1, 2048) rows.
PAR_PP = {"stages": 4, "micro": 4, "rows": 2048}
#: Experts: Mixtral-8x7B layer 0's int8 MoE FFN, 2 experts a rank, over
#: (4, 512, 4096) rows at a capacity factor of 4 (nothing drops).
PAR_EP = {"shape": (4, 512, 4096), "capacity_factor": 4.0}
#: Serving: Llama-3-8B at tp = 4 on the engine phase's shape; once more
#: with chunked prefill.  The decode step check's prompt lengths.
PAR_SERVE = {"slots": 4, "max_len": 2048, "new": 17, "burst": 8, "chunk": 512}
PAR_STEP_LENS = (100, 37, 128, 64)
PAR_LABEL = "four ranks sharing one card over gloo, no scaling figure"


def _par_qkv(group: str):
    """The same draws in the parent and in every rank."""
    b, hq, hkv, s, d = PAR_SHAPES[group]
    gen = torch.Generator("cuda").manual_seed(17 if group == "protocol" else 18)
    return _randn((b, hq, s, d), gen), _randn((b, hkv, s, d), gen), _randn((b, hkv, s, d), gen)


def _par_operands(qkv, scaling):
    q, k, v = qkv
    if scaling is None:
        return (q, k, v), {}
    fn = quant.quantize_head_wise if scaling == "head" else quant.quantize_token_wise
    (q8, sq), (k8, sk) = (fn(t, torch.float8_e4m3fn) for t in (q, k))
    return (q8, k8, v), {"scale_q": sq, "scale_k": sk}


def _par_attention_refs() -> dict:
    """Unsharded K1 on each case's inputs, and the fp32 oracle on one
    batch entry and two query heads (with their KV head)."""
    refs = {}
    for group in PAR_SHAPES:
        qkv = _par_qkv(group)
        group_kv = 1 if PAR_SHAPES[group][2] < PAR_SHAPES[group][1] else 2
        for name, (_, g, scaling, window) in PAR_ATTN.items():
            if g != group:
                continue
            args, scales = _par_operands(qkv, scaling)
            ref = flash_attention(*args, is_causal=True, window=window, **scales)
            cut = [args[0][:1, :2]] + [a[:1, :group_kv] for a in args[1:]]
            cut_scales = {"scale_q": scales["scale_q"][:1, :2], "scale_k": scales["scale_k"][:1, :group_kv]} if scales else {}
            oracle = sdpa_reference(*cut, is_causal=True, window=window, out_dtype=torch.float32, **cut_scales)
            refs[name] = (ref, oracle)
        del qkv
        torch.cuda.empty_cache()
    return refs


def _pp_setup():
    cfg = llama.llama3_8b(num_layers=PAR_PP["stages"], vocab_size=128, attention_impl="bf16")
    gen = torch.Generator("cuda").manual_seed(19)
    layers = llama.init_params(gen, cfg, "cuda")["layers"]
    stacked = {key: torch.stack([layer[key] for layer in layers]) for key in layers[0]}
    x = _randn((PAR_PP["micro"], 1, PAR_PP["rows"], cfg.hidden_size), gen)
    cos, sin = llama.rope_table(torch.arange(PAR_PP["rows"], device="cuda"), cfg.head_dim, cfg.rope_theta)

    def stage(p, a):  # one decoder layer, K1 causal
        attn, _, _ = llama._layer_attention(cfg, 0, p, a, cos, sin,
                                            lambda _i, q, k, v: flash_attention(q, k, v, is_causal=True))
        return llama._layer_tail(cfg, p, a, attn)[0]

    return stage, stacked, x


def _ep_setup():
    cfg = llama.mixtral_8x7b(num_layers=1)
    gen = torch.Generator("cuda").manual_seed(20)
    layer = quantized.init_quantized_params(gen, cfg, device="cuda")["layers"][0]
    return cfg, layer["moe"], _randn(PAR_EP["shape"], gen)


def _par_local_tree(cfg, mesh, int8: bool):
    """This rank's Megatron slices of Llama-3-8B's seed-0 tree, each matrix
    drawn (and quantized) whole, then cut: one whole matrix is live at a
    time, never the tree."""
    specs = mesh_lib.llama_param_specs(cfg)
    leaf_specs = {**specs["layers"][0], "embed": specs["embed"], "lm_head": specs["lm_head"]}

    def local(name, w):
        if int8:
            w = quantized.quantize_embed(w) if name == "embed" else quantized.quantize_matrix(w)
        if isinstance(w, dict):
            return mesh_lib.shard_params(w, mesh, mesh_lib.quantized_specs(w, leaf_specs[name]))
        return mesh_lib.shard_tensor(w, mesh, leaf_specs[name])

    return llama.init_params(torch.Generator("cuda").manual_seed(0), cfg, "cuda", transform=local)


def _par_serve(tree, cfg, mesh=None, chunk=None) -> dict:
    """The engine phase's prompts on 4 slots, 17 greedy tokens each, bursts
    of 8, on one card or over ``mesh``: each prefill's last-row logits and
    ms, decode ms a step (bursts that captured a graph left out), the
    tokens, then one decode step's logits after a fresh prefill of 4
    prompts."""
    eng = Engine(tree, cfg, num_slots=PAR_SERVE["slots"], max_len=PAR_SERVE["max_len"],
                 cache_dtype=torch.int8, prefill_chunk=chunk, mesh=mesh, device="cuda")
    backend = eng._backend
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=PAR_SERVE["new"])
            for n in SERVE_PROMPTS]
    logits, t = [], {"prefill": 0.0, "decode": 0.0, "decode_n": 0}

    def timed(owner, name, key, steps=None):
        fn = getattr(owner, name)

        def run(*a):
            captures = backend.stats["graph_captures"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            if steps is None:
                t[key] += time.perf_counter() - t0
                logits.append(out.float().cpu().numpy())
            elif backend.stats["graph_captures"] == captures:
                t[key] += time.perf_counter() - t0
                t["decode_n"] += steps(a)
            return out

        setattr(owner, name, run)

    timed(backend, "prefill_and_write", "prefill")
    timed(eng, "_prefill_one_chunk", "prefill")
    timed(backend, "decode", "decode", lambda a: 1)
    timed(backend, "burst", "decode", lambda a: a[6])
    eng.run_to_completion(decode_burst=PAR_SERVE["burst"])
    for owner, name in ((backend, "prefill_and_write"), (eng, "_prefill_one_chunk"),
                        (backend, "decode"), (backend, "burst")):
        delattr(owner, name)
    for r in reqs:
        if not r.done or len(r.output) != PAR_SERVE["new"]:
            raise RuntimeError(f"parallel serve: request {r.id} ended with {len(r.output)} tokens")
    rng = np.random.default_rng(1)
    tokens = torch.zeros((4, 128), dtype=torch.int64)
    for i, n in enumerate(PAR_STEP_LENS):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
    slots = [0, 1, 2, 3]
    backend.prefill_and_write(eng._prefill_fn, eng.params, tokens.cuda(), [n - 1 for n in PAR_STEP_LENS],
                              slots, list(PAR_STEP_LENS), 128)
    step = backend.decode(eng.params, rng.integers(0, cfg.vocab_size, 4), np.ones(4, bool), slots)
    rec = {"prefill": logits, "step": step.float().cpu().numpy(), "outputs": [r.output for r in reqs],
           "prefill_tok_s": eng.stats["prefill_tokens"] / t["prefill"],
           "decode_ms_per_step": 1e3 * t["decode"] / max(1, t["decode_n"]),
           "stats": dict(eng.stats)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _par_serve_runs(cfg, mesh=None) -> dict:
    """The bf16 tree, the same tree with chunked prefill, then the unfused
    int8 tree: whole on one card (``mesh`` None), or this rank's slices."""
    if mesh is None:
        tree = llama.init_params(torch.Generator("cuda").manual_seed(0), cfg, "cuda")
    else:
        tree = _par_local_tree(cfg, mesh, int8=False)
    runs = {"bf16": _par_serve(tree, cfg, mesh), "bf16_chunked": _par_serve(tree, cfg, mesh, PAR_SERVE["chunk"])}
    if mesh is None:
        tree = quantized.quantize_params(tree)
    else:
        del tree
        gc.collect()
        torch.cuda.empty_cache()
        tree = _par_local_tree(cfg, mesh, int8=True)
    runs["int8"] = _par_serve(tree, cfg, mesh)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _parallel_rank(rank: int, world: int, store: str, out_dir: str, results) -> None:
    """One rank of the mesh phase: the attention cases, the pipeline, the
    experts and tensor-parallel serving, every kernel on the card; big
    outputs to ``out_dir``, the rest (errors, launch counts, staged bytes,
    serving records) to ``results``."""
    import traceback

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))  # the host's cores, shared
        backend_name = multihost.initialize_distributed(f"file://{store}", world, rank)
        _reset_counts()
        mesh_lib.staged_bytes = 0
        meshes = {a: mesh_lib.make_mesh((world,), (a,)) for a in ("sp", "tp", "pp", "ep")}
        rec = {"rank": rank, "backend": backend_name, "attention_wall_ms": {}}
        for group in PAR_SHAPES:
            qkv = _par_qkv(group)
            for name, (fn, g, scaling, window) in PAR_ATTN.items():
                if g != group:
                    continue
                args, scales = _par_operands(qkv, scaling)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if fn == "head":
                    out = head_parallel_attention(*args, mesh=meshes["tp"], is_causal=True, window=window, **scales)
                else:
                    seq = lambda t: mesh_lib.shard(t, meshes["sp"], "sp", 2)  # noqa: E731
                    local = {key: seq(s) if s.ndim == 3 else s for key, s in scales.items()}
                    call = ring_attention if fn == "ring" else ulysses_attention
                    out = call(*(seq(a) for a in args), mesh=meshes["sp"], is_causal=True, window=window, **local)
                torch.cuda.synchronize()
                rec["attention_wall_ms"][name] = 1e3 * (time.perf_counter() - t0)
                torch.save(out.cpu(), os.path.join(out_dir, f"{name}_{rank}.pt"))
                del out, args, scales
            del qkv
            torch.cuda.empty_cache()
        stage, stacked, x = _pp_setup()
        out = pipeline_apply(stage, stacked, x, mesh=meshes["pp"])
        if rank == 0:
            torch.save(out.cpu(), os.path.join(out_dir, "pipeline.pt"))
        rec["pipeline_sum"] = float(out.float().sum())
        del stage, stacked, x, out
        cfg, moe_params, x = _ep_setup()
        y = expert_parallel_ffn(moe_params, x, mesh=meshes["ep"], num_experts_per_tok=cfg.num_experts_per_tok,
                                capacity_factor=PAR_EP["capacity_factor"])
        torch.save(y.cpu(), os.path.join(out_dir, f"experts_{rank}.pt"))
        del moe_params, x, y
        torch.cuda.empty_cache()
        rec["serve"] = _par_serve_runs(llama.llama3_8b(), meshes["tp"])
        torch.cuda.synchronize()
        rec["launches"] = _counts()
        rec["staged_bytes"] = mesh_lib.staged_bytes
        rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        results.put(rec)
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 — the rank's boundary: the parent raises it
        results.put({"rank": rank, "error": traceback.format_exc()})


def _spawn_world(out_dir: str, target=None, timeout_s: float = PAR["timeout_s"]) -> list:
    """Run ``target`` (``_parallel_rank`` by default) in PAR["world"]
    spawned processes (a ``file://`` store); every process is stopped
    before this returns."""
    import queue as queue_lib

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=target or _parallel_rank, args=(r, PAR["world"], store, out_dir, results),
                         daemon=True)
             for r in range(PAR["world"])]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    recs = []
    try:
        while len(recs) < len(procs):
            try:
                rec = results.get(timeout=5.0)
            except queue_lib.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    raise RuntimeError(f"parallel: {len(recs)} of {len(procs)} ranks reported "
                                       f"(exit codes {[p.exitcode for p in procs]})")
                continue
            if "error" in rec:
                raise RuntimeError(f"parallel: rank {rec['rank']} failed:\n{rec['error']}")
            recs.append(rec)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(recs, key=lambda r: r["rank"])


def _rel_rows(a, b) -> float:
    """The largest row's ||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def phase_parallel() -> dict:
    """The parallel layer on the card: the unsharded references here, then
    a world of four ranks sharing the card over gloo (``_parallel_rank``).
    Checks: every attention case within 1/32 of unsharded K1 and under the
    RMSE bar of the fp32 oracle on one batch entry and two heads, finite;
    the pipeline within 1e-2 RMSE of the stages applied in sequence, the
    same on every rank; the experts within 2^-6 max-relative of the
    single-card ``moe_ffn``; serving: every rank the same tokens, each
    prefill's logits within 10% and a decode step within 5% of the
    single-card engine's; K1, K4, K5 and K6 launched on the mesh path.
    Returns the launches summed over the ranks."""
    gc.collect()
    torch.cuda.empty_cache()
    _native.library()  # built here, loaded by every rank
    t_start = time.perf_counter()
    with _uncounted():
        refs = _par_attention_refs()
        stage, stacked, x = _pp_setup()
        pp_ref = torch.stack([functools.reduce(lambda a, i: stage({k: w[i] for k, w in stacked.items()}, a),
                                               range(PAR_PP["stages"]), x[m]) for m in range(PAR_PP["micro"])])
        del stage, stacked, x
        cfg_ep, moe_params, x = _ep_setup()
        ep_ref = moe.moe_ffn(moe_params, x, num_experts_per_tok=cfg_ep.num_experts_per_tok,
                             capacity_factor=PAR_EP["capacity_factor"])
        del moe_params, x
        torch.cuda.empty_cache()
        single = _par_serve_runs(llama.llama3_8b())
    ref_s = time.perf_counter() - t_start
    out_dir = tempfile.mkdtemp(prefix="qa_parallel_")
    try:
        t0 = time.perf_counter()
        ranks = _spawn_world(out_dir)
        world_s = time.perf_counter() - t0
        rec = {"backend": ranks[0]["backend"], "world": PAR["world"], "label": PAR_LABEL,
               "staged_bytes": sum(r["staged_bytes"] for r in ranks),
               "peak_GB_per_rank": [r["peak_GB"] for r in ranks], "refs_s": ref_s, "world_s": world_s}
        for name, (fn, _, _, _) in PAR_ATTN.items():
            out = torch.cat([torch.load(os.path.join(out_dir, f"{name}_{r}.pt")) for r in range(PAR["world"])],
                            dim=1 if fn == "head" else 2).cuda()
            ref, oracle = refs[name]
            case = {"max_abs_vs_k1": max_abs(out, ref), "rmse_vs_oracle": rmse(out[:1, :2], oracle),
                    "finite": bool(torch.isfinite(out).all()),
                    "wall_ms": [r["attention_wall_ms"][name] for r in ranks]}
            rec[name] = case
            if not (case["finite"] and case["max_abs_vs_k1"] <= KERNEL_VS_PLAIN_ATOL
                    and case["rmse_vs_oracle"] < RMSE_BAR):
                raise RuntimeError(f"parallel {name} disagrees: {case}")
            del out
        pp = torch.load(os.path.join(out_dir, "pipeline.pt")).cuda()
        rec["pipeline"] = {"rmse_vs_sequential": rmse(pp, pp_ref), "sums": [r["pipeline_sum"] for r in ranks]}
        if not rec["pipeline"]["rmse_vs_sequential"] < RMSE_BAR or len(set(rec["pipeline"]["sums"])) != 1:
            raise RuntimeError(f"parallel pipeline disagrees: {rec['pipeline']}")
        ep = torch.cat([torch.load(os.path.join(out_dir, f"experts_{r}.pt")) for r in range(PAR["world"])]).cuda()
        rec["experts"] = {"max_rel_vs_single": max_rel(ep, ep_ref)}
        if not rec["experts"]["max_rel_vs_single"] <= QUANT_KERNEL_REL:
            raise RuntimeError(f"parallel experts disagree: {rec['experts']}")
        for run, one in single.items():
            tp = [r["serve"][run] for r in ranks]
            if any(t["outputs"] != tp[0]["outputs"] for t in tp):
                raise RuntimeError(f"parallel serve {run}: the ranks emitted different tokens")
            if len(tp[0]["prefill"]) != len(one["prefill"]):
                raise RuntimeError(f"parallel serve {run}: {len(tp[0]['prefill'])} prefills, "
                                   f"{len(one['prefill'])} on one card")
            served = {
                "prefill_rel": max(_rel_rows(a, b) for a, b in zip(tp[0]["prefill"], one["prefill"])),
                "step_rel": _rel_rows(tp[0]["step"], one["step"]),
                "first_tokens_equal": [a[0] == b[0] for a, b in zip(tp[0]["outputs"], one["outputs"])],
                "tp4_prefill_tok_s": tp[0]["prefill_tok_s"], "single_prefill_tok_s": one["prefill_tok_s"],
                "tp4_decode_ms_per_step": tp[0]["decode_ms_per_step"],
                "single_decode_ms_per_step": one["decode_ms_per_step"],
                "prefill_forwards": tp[0]["stats"]["prefill_forwards"],
            }
            rec[f"serve_{run}"] = served
            if not (served["prefill_rel"] <= PREFILL_REL_BOUND and served["step_rel"] <= DECODE_K8_REL_BOUND):
                raise RuntimeError(f"parallel serve {run} disagrees with one card: {served}")
        launches = {key: sum(r["launches"][key] for r in ranks) for key in ("k1", "k4", "k5", "k6")}
        rec["launches"] = launches
        log("parallel " + json.dumps(rec))
        idle = [key for key, n in launches.items() if n <= 0]
        if idle:
            raise RuntimeError(f"parallel: kernels the mesh path never launched: {idle}")
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Training under a (dp, tp) mesh: four ranks sharing the card over gloo
# ---------------------------------------------------------------------------

#: Each case at published widths, seeded bf16 weights, the depth cut (the
#: only cut), over a batch of 2 rows x 1024 positions (one row a dp rank of
#: the (dp 2, tp 2) mesh ``dryrun_multichip`` builds at four devices,
#: __graft_entry__.py:32-73); two SGD steps, the first checked, the second
#: timed.  The gradients of the checked leaves are the ones ``train_step``
#: applies (taken from its ``loss_and_grads``), held to TRAIN_GRAD_BOUND of
#: the attention path against one card's.
PAR_TRAIN = {
    "llama3_70b": {"layers": 2, "impl": "bf16", "seed": 41},
    "mixtral_8x7b": {"layers": 1, "impl": "fp8", "seed": 42},
}
PAR_TRAIN_MESH = (2, 2)
PAR_TRAIN_ROWS = 2
PAR_TRAIN_POSITIONS = 1024
PAR_TRAIN_TIMEOUT_S = 600


def _par_train_cfg(name: str):
    """The case's preset (``llama.<name>``) at its depth and attention path."""
    case = PAR_TRAIN[name]
    kw = {"attention_impl": "bf16"} if case["impl"] == "bf16" else {}
    return getattr(llama, name)(num_layers=case["layers"], **kw)


def _par_train_tokens(name: str, cfg) -> torch.Tensor:
    rng = np.random.default_rng(PAR_TRAIN[name]["seed"])
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (PAR_TRAIN_ROWS, PAR_TRAIN_POSITIONS + 1)))


def _par_train_checked(grads, cfg, tokens: torch.Tensor, vocab_lo: int = 0) -> dict:
    """The gradient leaves the phase compares: layer 0's and the last
    layer's wq, wo and w_down (an MoE layer's expert w_down and router),
    layer 0's attn_norm, final_norm, the LM head, and the embedding rows of
    the batch's input tokens that fall in this table's slice (rows
    ``vocab_lo`` on), in ascending token order."""
    out = {}
    for i in sorted({0, cfg.num_layers - 1}):
        layer = grads["layers"][i]
        out[f"layers.{i}.wq"], out[f"layers.{i}.wo"] = layer["wq"], layer["wo"]
        if cfg.num_experts:
            out[f"layers.{i}.moe.w_down"] = layer["moe"]["w_down"]
            out[f"layers.{i}.moe.w_router"] = layer["moe"]["w_router"]
        else:
            out[f"layers.{i}.w_down"] = layer["w_down"]
    out["layers.0.attn_norm"], out["final_norm"], out["lm_head"] = (
        grads["layers"][0]["attn_norm"], grads["final_norm"], grads["lm_head"])
    rows = torch.unique(tokens[:, :-1]).to(grads["embed"].device) - vocab_lo
    rows = rows[(rows >= 0) & (rows < grads["embed"].shape[0])]
    out["embed_rows"] = grads["embed"][rows]
    return out


@contextlib.contextmanager
def _train_step_grads(keep, kept: list):
    """Inside the block, every ``llama.loss_and_grads`` call (the one
    ``train_step`` makes) appends ``keep(grads)`` copied to host memory to
    ``kept``, before the update runs."""
    orig = llama.loss_and_grads

    def capturing(*a, **kw):
        loss, grads = orig(*a, **kw)
        kept.append({name: t.detach().cpu() for name, t in keep(grads).items()})
        return loss, grads

    llama.loss_and_grads = capturing
    try:
        yield kept
    finally:
        llama.loss_and_grads = orig


def _replicated_leaves(params) -> dict:
    """The leaves the mesh replicates (every norm, final_norm, every router;
    all fp32), as numpy arrays."""
    out = {"final_norm": params["final_norm"]}
    for i, layer in enumerate(params["layers"]):
        out[f"layers.{i}.attn_norm"] = layer["attn_norm"]
        out[f"layers.{i}.mlp_norm"] = layer["mlp_norm"]
        if "moe" in layer:
            out[f"layers.{i}.moe.w_router"] = layer["moe"]["w_router"]
    return {k: t.cpu().numpy() for k, t in out.items()}


def _timed_step(params, tokens, cfg, mesh=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, loss = llama.train_step(params, tokens, cfg, mesh=mesh)
    loss = float(loss)
    torch.cuda.synchronize()
    return params, loss, 1e3 * (time.perf_counter() - t0)


def _par_train_single(name: str) -> dict:
    """One card's two steps on the whole batch, the first's checked
    gradients and expert choices kept on the host; everything on the card
    freed after."""
    cfg = _par_train_cfg(name)
    tokens = _par_train_tokens(name, cfg)
    params = llama.init_params(torch.Generator("cuda").manual_seed(PAR_TRAIN[name]["seed"]), cfg, "cuda")
    kept, routing = [], []
    with _train_step_grads(lambda g: _par_train_checked(g, cfg, tokens), kept), _moe_routing(routing):
        params, loss1, ms1 = _timed_step(params, tokens.cuda(), cfg)
    torch.cuda.reset_peak_memory_stats()
    params, loss2, ms2 = _timed_step(params, tokens.cuda(), cfg)
    rec = {"grads": kept[0], "losses": [loss1, loss2], "step_ms": ms2,
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9, "routing": [e.cpu() for e in routing]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _par_train_local_tree(cfg, mesh, seed: int):
    """This rank's shards of the case's seeded tree: each matrix drawn whole
    (the draws of one card's ``init_params``), then cut."""
    specs = mesh_lib.llama_param_specs(cfg)
    layer_specs = specs["layers"][0]

    def spec(name):
        if name.startswith("moe."):
            return layer_specs["moe"][name[4:]]
        return specs[name] if name in specs else layer_specs[name]

    return llama.init_params(torch.Generator("cuda").manual_seed(seed), cfg, "cuda",
                             transform=lambda name, w: mesh_lib.shard_tensor(w, mesh, spec(name)))


def _par_train_rank_case(name: str, mesh, out_dir: str) -> dict:
    """One case on this rank: step 1 through ``train_step(mesh=)`` with its
    gradients kept (an MoE layer replaying one card's expert choices for
    this rank's rows, ``_moe_routing``), step 2 timed.  Ranks at dp 0 save
    their checked gradient shards for the parent; every rank reports its
    replicated leaves, the hashes of its checked gradients and its own
    expert choices."""
    import hashlib

    cfg = _par_train_cfg(name)
    dp, tp = mesh_lib.axis_rank(mesh, "dp"), mesh_lib.axis_rank(mesh, "tp")
    tree = _par_train_local_tree(cfg, mesh, PAR_TRAIN[name]["seed"])
    gc.collect()
    torch.cuda.empty_cache()
    tokens = _par_train_tokens(name, cfg)
    local_tokens = tokens[dp:dp + 1].cuda()
    vocab_lo = tp * cfg.vocab_size // mesh_lib.axis_size(mesh, "tp")
    torch.cuda.reset_peak_memory_stats()
    mesh_lib.staged_bytes = 0
    rows = slice(dp * PAR_TRAIN_POSITIONS, (dp + 1) * PAR_TRAIN_POSITIONS)
    routing = [e[rows].cuda() for e in torch.load(os.path.join(out_dir, f"{name}_routing.pt"))]
    kept, experts = [], []
    _moe_routing.flips = _moe_routing.choices = 0
    with _train_step_grads(lambda g: _par_train_checked(g, cfg, tokens, vocab_lo), kept), \
            _moe_routing(routing, replay=bool(routing), own_choices=experts):
        tree, loss1, ms1 = _timed_step(tree, local_tokens, cfg, mesh)
    replicated_1 = _replicated_leaves(tree)
    staged_1 = mesh_lib.staged_bytes
    tree, loss2, ms2 = _timed_step(tree, local_tokens, cfg, mesh)
    rec = {"losses": [loss1, loss2], "step_ms": ms2, "first_step_ms": ms1,
           "staged_bytes_per_step": [staged_1, mesh_lib.staged_bytes - staged_1],
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
           "replicated": [replicated_1, _replicated_leaves(tree)],
           "grad_sha1": {k: hashlib.sha1(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
                         for k, t in kept[0].items() if k != "embed_rows"},
           "experts": [e.cpu().numpy() for e in experts], "flips": _moe_routing.flips,
           "choices": _moe_routing.choices}
    if dp == 0:
        torch.save(kept[0], os.path.join(out_dir, f"{name}_grads_{tp}.pt"))
    del tree, kept
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _parallel_train_rank(rank: int, world: int, store: str, out_dir: str, results) -> None:
    """One rank of the mesh training phase: every case of PAR_TRAIN on a
    (dp 2, tp 2) mesh, K1, K2 and K3 on this rank's heads."""
    import traceback

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))  # the host's cores, shared
        backend_name = multihost.initialize_distributed(f"file://{store}", world, rank)
        mesh = mesh_lib.make_mesh(PAR_TRAIN_MESH, ("dp", "tp"))
        rec = {"rank": rank, "backend": backend_name, "dp": mesh_lib.axis_rank(mesh, "dp"),
               "tp": mesh_lib.axis_rank(mesh, "tp")}
        _reset_train_counts()
        for name in PAR_TRAIN:
            rec[name] = _par_train_rank_case(name, mesh, out_dir)
        rec["launches"] = _train_counts()
        results.put(rec)
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 — the rank's boundary: the parent raises it
        results.put({"rank": rank, "error": traceback.format_exc()})


def _par_train_case_checks(name: str, ranks: list, single: dict, out_dir: str) -> dict:
    """One case's checks against one card: the loss, the checked gradients
    put back together from the dp-0 ranks' shards, dp replicas' gradients
    equal, replicated leaves equal on all ranks, expert choices equal
    across tp."""
    cfg = _par_train_cfg(name)
    impl = PAR_TRAIN[name]["impl"]
    specs = mesh_lib.llama_param_specs(cfg)
    n_tp = PAR_TRAIN_MESH[1]
    shards = [torch.load(os.path.join(out_dir, f"{name}_grads_{t}.pt")) for t in range(n_tp)]
    errs = {}
    for key, ref in single["grads"].items():
        if key == "embed_rows":
            dim = 0
        else:
            node = specs
            for part in key.split("."):
                node = node[int(part)] if isinstance(node, list) else node[part]
            dims = [d for d, ax in enumerate(node) if ax is not None]
            dim = dims[0] if dims else None
        whole = shards[0][key] if dim is None else torch.cat([s[key] for s in shards], dim=dim)
        errs[key] = rel_fro(whole.cuda(), ref.cuda())
    del shards
    mine = [r[name] for r in ranks]
    loss_rel = abs(mine[0]["losses"][0] - single["losses"][0]) / abs(single["losses"][0])
    replicas_equal = all(
        r[name]["grad_sha1"] == q[name]["grad_sha1"] for r in ranks for q in ranks if r["tp"] == q["tp"])
    replicated_equal = all(
        np.array_equal(a, b) for m in mine for i in range(2)
        for a, b in zip(m["replicated"][i].values(), mine[0]["replicated"][i].values()))
    experts_equal = all(
        len(r[name]["experts"]) == len(q[name]["experts"])
        and all(np.array_equal(a, b) for a, b in zip(r[name]["experts"], q[name]["experts"]))
        for r in ranks for q in ranks if r["dp"] == q["dp"])
    rec = {"layers": cfg.num_layers, "impl": impl, "hidden": cfg.hidden_size, "heads": cfg.num_q_heads,
           "kv_heads": cfg.num_kv_heads, "experts": cfg.num_experts, "rows": PAR_TRAIN_ROWS,
           "positions": PAR_TRAIN_POSITIONS, "cut": f"num_layers {cfg.num_layers}",
           "losses": mine[0]["losses"], "single_losses": single["losses"], "loss_rel": loss_rel,
           "grad_rel_fro": errs, "bound": TRAIN_GRAD_BOUND[impl],
           "losses_equal_on_ranks": all(m["losses"] == mine[0]["losses"] for m in mine),
           "replicated_equal": replicated_equal, "dp_replica_grads_equal": replicas_equal,
           "experts_equal_across_tp": experts_equal,
           "routing_flips_vs_single": [m["flips"] for m in mine], "routed_tokens": [m["choices"] for m in mine],
           "step_ms": max(m["step_ms"] for m in mine), "single_step_ms": single["step_ms"],
           "tok_s": PAR_TRAIN_ROWS * PAR_TRAIN_POSITIONS / (1e-3 * max(m["step_ms"] for m in mine)),
           "single_tok_s": PAR_TRAIN_ROWS * PAR_TRAIN_POSITIONS / (1e-3 * single["step_ms"]),
           "first_step_ms": max(m["first_step_ms"] for m in mine),
           "staged_bytes_per_step": [sum(m["staged_bytes_per_step"][i] for m in mine) for i in range(2)],
           "peak_GB_per_rank": [m["peak_GB"] for m in mine], "single_peak_GB": single["peak_GB"]}
    if not (loss_rel < 1e-2 and all(np.isfinite(m["losses"]).all() for m in mine)
            and rec["losses_equal_on_ranks"]):
        raise RuntimeError(f"parallel_train {name}: losses off: {rec}")
    if not all(e < TRAIN_GRAD_BOUND[impl] for e in errs.values()):
        raise RuntimeError(f"parallel_train {name}: gradients off one card's: {errs}")
    if not (replicated_equal and replicas_equal and experts_equal):
        raise RuntimeError(f"parallel_train {name}: ranks disagree: {rec}")
    if cfg.num_experts and not all(m["experts"] for m in mine):
        raise RuntimeError(f"parallel_train {name}: no expert choices recorded")
    return rec


def phase_parallel_train() -> dict:
    """Training under a (dp 2, tp 2) mesh on four ranks sharing the card
    over gloo (``llama.train_step(mesh=)``): Llama-3-70B's widths at 2
    layers in bf16 and Mixtral-8x7B's at 1 layer in fp8 head-wise, each
    beside one card's step on the same batch through the same kernels
    (computed and freed before the ranks start).  Returns K1, K2 and K3's
    launches summed over the ranks."""
    gc.collect()
    torch.cuda.empty_cache()
    _native.library()  # built here, loaded by every rank
    t_start = time.perf_counter()
    single = {name: _par_train_single(name) for name in PAR_TRAIN}
    ref_s = time.perf_counter() - t_start
    out_dir = tempfile.mkdtemp(prefix="qa_parallel_train_")
    try:
        for name, one in single.items():
            torch.save(one["routing"], os.path.join(out_dir, f"{name}_routing.pt"))
        t0 = time.perf_counter()
        ranks = _spawn_world(out_dir, _parallel_train_rank, PAR_TRAIN_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        rec = {"backend": ranks[0]["backend"], "world": PAR["world"], "mesh": PAR_TRAIN_MESH,
               "label": PAR_LABEL, "refs_s": ref_s, "world_s": world_s}
        for name in PAR_TRAIN:
            rec[name] = _par_train_case_checks(name, ranks, single[name], out_dir)
        launches = {key: sum(r["launches"][key] for r in ranks) for key in ("k1", "k2", "k3", "sdpa_fallback")}
        rec["launches"] = launches
        rec["launches_per_rank"] = [{key: r["launches"][key] for key in ("k1", "k2", "k3")} for r in ranks]
        rec["wall_s"] = time.perf_counter() - t_start
        log("parallel_train " + json.dumps(rec))
        if launches["sdpa_fallback"] or any(n <= 0 for r in rec["launches_per_rank"] for n in r.values()):
            raise RuntimeError(f"parallel_train: a rank skipped a kernel or fell back: {rec['launches_per_rank']}, "
                               f"{launches['sdpa_fallback']} SDPA fallbacks")
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main() -> int:
    if not checks.cuda_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    # Every run sweeps from an empty autotune cache, in a directory of its own.
    cache_dir = tempfile.mkdtemp(prefix="qa_autotune_")
    os.environ["QUANTUM_ATTN_CACHE_DIR"] = cache_dir
    autotune._CACHE = None
    try:
        return _main()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"card {smi}")
    env = phase_env()
    gen = torch.Generator("cuda").manual_seed(0)
    if "--split-only" in sys.argv[1:]:
        phase_split(gen)
        return 0
    if "--engine-burst-only" in sys.argv[1:]:
        cfg = llama.llama3_8b()
        phase_engine_burst(llama.init_params(torch.Generator("cuda").manual_seed(0), cfg, "cuda"))
        return 0
    if "--serve-order-only" in sys.argv[1:]:
        phase_serve_order(llama.init_params(torch.Generator("cuda").manual_seed(0),
                                            llama.llama3_8b(), "cuda"))
        return 0
    if "--k1-dense-only" in sys.argv[1:]:
        phase_k1_dense_ab(gen)
        return 0
    if "--k1-modes-only" in sys.argv[1:]:
        phase_k1_modes(gen)
        return 0
    if "--mixtral-only" in sys.argv[1:]:
        phase_fuzz()
        log("mixtral launches " + json.dumps(phase_mixtral()))
        return 0
    if "--parallel-only" in sys.argv[1:]:
        log("parallel launches " + json.dumps(phase_parallel()))
        return 0
    if "--parallel-train-only" in sys.argv[1:]:
        log("parallel_train launches " + json.dumps(phase_parallel_train()))
        return 0
    if "--quant-prefill-only" in sys.argv[1:]:
        params = llama.init_params(torch.Generator("cuda").manual_seed(0), llama.llama3_8b(), "cuda")
        for label, quant_fn in (("serve_int8", quantized.quantize_params),
                                ("serve_int4", quantized.quantize_params_int4)):
            tree = quantized.fuse_projections(quant_fn(params))
            _quant_prefill(label, tree)
            del tree
            gc.collect()
            torch.cuda.empty_cache()
        return 0
    k1 = phase_k1(gen)
    bq = phase_block_quant(gen)
    k1.update(phase_k1_block(gen))
    phase_autotune(gen)
    k1.update(phase_k1_modes(gen))
    k4 = phase_k4(gen)
    phase_k1_residuals(gen)
    k23 = phase_k23(gen)
    phase_fuzz()
    k567 = phase_qmm(gen)
    k8 = phase_k8(gen)
    k9 = phase_k9(gen)
    k10 = phase_k10(gen)
    window = phase_window_kernels(gen)
    launches, params = phase_engine()
    phase_engine_burst(params)
    q8 = phase_quant_serving(params, int4=False)
    q4 = phase_quant_serving(params, int4=True)
    s64 = phase_serve_int8_64(params)
    paged = phase_serve_paged_prefix_16(params)
    phase_serve_lowbit(params)
    spec = phase_speculative(params)
    phase_serve_d256()
    phase_d96()
    per_block = phase_serve_per_block(params)
    train = phase_train(params)
    phase_train_per_block(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mistral = phase_mistral()
    mixtral = phase_mixtral()
    par = phase_parallel()
    ptrain = phase_parallel_train()
    k23["dq"]["library_ms"] = k23["dkv"]["library_ms"] = phase_sdpa_backward(gen)
    phase_split(gen)  # last: the profiler stays out of every other phase's timings
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["k1"], "launches_window": mistral["k1"],
         "launches_moe": mixtral["k1"], "launches_parallel": par["k1"] + ptrain["k1"], **k1, **window["k1"]},
        {"name": "decode", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches["k4"], "launches_verify": spec["k4_verify"],
         "launches_window": mistral["k4"], "launches_moe": mixtral["k4"], "launches_parallel": par["k4"],
         **k4, **window["k4"]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": K23_SOURCE,
         "replaces": K2_REPLACES, "launches": train["k2"], "launches_window": mistral["k2"],
         "launches_moe": mixtral["k2"], "launches_parallel": ptrain["k2"], **k23["dq"], **window["dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": K23_SOURCE,
         "replaces": K3_REPLACES, "launches": train["k3"], "launches_window": mistral["k3"],
         "launches_moe": mixtral["k3"], "launches_parallel": ptrain["k3"], **k23["dkv"], **window["dkv"]},
        {"name": "qmm", "route": "cuda", "source": QGEMM_SOURCE, "replaces": K5_REPLACES,
         "launches": q8["k5"] + q4["k5"], "launches_moe": mixtral["k5"], "launches_parallel": par["k5"],
         **k567["k5"]},
        {"name": "qmm_splitk", "route": "cuda", "source": QGEMM_SOURCE, "replaces": K6_REPLACES,
         "launches": q8["k6"] + q4["k6"], "launches_moe": mixtral["k6"], "launches_parallel": par["k6"],
         **k567["k6"]},
        {"name": "qmm4", "route": "cuda", "source": QGEMM_SOURCE, "replaces": K7_REPLACES,
         "launches": q4["k7"], **k567["k7"]},
        {"name": "layer_tail", "route": "cuda", "source": K8_SOURCE, "replaces": K8_REPLACES,
         "launches": q8["k8"] + q4["k8"], **k8},
        {"name": "fused_decode_layer", "route": "cuda", "source": K9_SOURCE,
         "replaces": K9_REPLACES, "launches": s64["k9"], "launches_window": mistral["k9"],
         **k9, **window["k9"]},
        {"name": "paged_decode", "route": "cuda", "source": K10_SOURCE,
         "replaces": K10_REPLACES, "launches": paged["k10"], "launches_verify": spec["k10_verify"],
         "launches_window": mistral["k10"], "launches_moe": mixtral["k10"], **k10, **window["k10"]},
        {"name": "block_quant", "route": "cuda", "source": BLOCK_QUANT_SOURCE,
         "replaces": BLOCK_QUANT_REPLACES, "launches": per_block["block_quant"], **bq},
    ]
    log("autotune cache " + json.dumps(autotune._load_cache(), sort_keys=True))
    log("autotune counters " + json.dumps({
        "sweeps": autotune.sweeps, "timed": autotune.timed, "hits": autotune.hits,
        "misses_in_capture": autotune.misses_in_capture}))
    idle = [k["name"] for k in kernels if k["launches"] <= 0 or any(
        k.get(key, 1) <= 0 for key in ("launches_verify", "launches_window", "launches_segments",
                                       "launches_block_mask", "launches_int8_v", "launches_moe",
                                       "launches_parallel"))]
    if idle:
        raise RuntimeError(f"kernels the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device"], "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
