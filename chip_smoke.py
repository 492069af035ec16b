"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of their own:

1. environment: torch, CUDA, nvcc, the card, and the kernels' build time
   (every kernel is built here from ``quantumattention_tpu_torch/csrc``);
2. K1 (flash forward) against its plain version and the fp32 SDPA oracle
   at the serving shapes, with CUDA-event times of kernel and plain version;
3. K4 (decode) likewise, over a ragged int8 and a bf16 slot cache;
4. K1's residuals (m, l) against their plain version;
5. K2 (dQ) and K3 (dK, dV) against their plain version and against
   autograd of the fp32 oracle, with CUDA-event times of both kernels,
   their plain versions and the fp8 path's whole backward;
6. the engine: Llama-3-8B at full width and depth with seeded random bf16
   weights serves 6 greedy requests on 4 slots through K1 and K4; the
   launch counts prove the path went through the kernels, and each
   request's prefill logits are held against a plain-attention run;
7. training: the same weights take 3 SGD steps over 1024 positions through
   the fp8 path (K1 forward, K1 recompute, K2 and K3 backward); the launch
   counts prove it, the first loss is held against the plain path's, and
   the gradients of a 4-layer cut against plain attention's.

The last three lines are a JSON object with one entry per kernel, the
card's name and power limit (``nvidia-smi``), and ``{"ok": true,
"device": {...}}``.  Any failed check raises and the script exits
non-zero.  It needs one CUDA card and refuses to run without one.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from quantumattention_tpu_torch import config, dispatch
from quantumattention_tpu_torch.models import llama
from quantumattention_tpu_torch.ops import _native, quant
from quantumattention_tpu_torch.ops.autodiff import exact_attention_bwd
from quantumattention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
from quantumattention_tpu_torch.ops.flash import flash_attention, flash_attention_plain
from quantumattention_tpu_torch.ops.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    row_delta,
)
from quantumattention_tpu_torch.ops.sdpa import sdpa_reference
from quantumattention_tpu_torch.serving.engine import Engine
from quantumattention_tpu_torch.utils import checks

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
#: Engine prefill logits, fp8 kernel path against the plain fp32-attention
#: path on the same weights: ||a - b|| / ||b|| per request.  e4m3 keeps 3
#: mantissa bits, and the error of 32 random-weight layers adds up; a
#: broken kernel gives an error of order 1.
PREFILL_REL_BOUND = 0.1
#: K1's residuals against their plain version on the same inputs: the same
#: fp32 scores summed in another order (m absolute, l relative).
RESIDUAL_M_ATOL = 1e-3
RESIDUAL_L_RTOL = 1e-3
#: K2/K3 against their plain version and the fp32 oracle's autograd:
#: max|a - b| / max|b|, the JAX suite's bar (tests/test_autodiff.py:27-30).
GRAD_BAR = 2e-2
#: Training: the first step's loss against the plain path's on the same
#: weights (relative), and the 4-layer gradients against plain attention's
#: (relative Frobenius norm): bf16 rounds P and dS where the plain path
#: keeps fp32; fp8 adds its straight-through estimate.
LOSS_REL_BOUND = 0.05
TRAIN_GRAD_BOUND = {"bf16": 5e-2, "fp8": 1e-1}
TRAIN_POSITIONS = 1024
TRAIN_STEPS = 3
GRAD_CHECK_LAYERS = 4

K1_SOURCE = "quantumattention_tpu_torch/csrc/flash_fwd.cu"
K4_SOURCE = "quantumattention_tpu_torch/csrc/decode.cu"
K23_SOURCE = "quantumattention_tpu_torch/csrc/flash_bwd.cu"
K1_REPLACES = "quantumattention_tpu/ops/flash.py:123"
K4_REPLACES = "quantumattention_tpu/ops/decode.py:56"
K2_REPLACES = "quantumattention_tpu/ops/flash_bwd.py:112"
K3_REPLACES = "quantumattention_tpu/ops/flash_bwd.py:150"


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


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    return max_abs(a, b) / float(b.float().abs().max())


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


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def phase_k1(gen) -> dict:
    """K1 against its plain version and the fp32 oracle."""
    cases = [
        (b, s, mode, True, 128)
        for b in (1, 4) for s in (57, 512, 1536) for mode in ("bf16", "head", "token")
    ]
    cases += [(1, 512, "head", False, 128), (1, 512, "head", True, 64)]
    worst = 0.0
    timing = None
    for b, s, mode, causal, d in cases:
        q = _randn((b, 32, s, d), gen)
        k = _randn((b, 8, s, d), gen)
        v = _randn((b, 8, s, d), gen)
        if mode == "bf16":
            args, scales = (q, k, v), {}
        else:
            quantize = quant.quantize_head_wise if mode == "head" else quant.quantize_token_wise
            q8, sq = quantize(q, torch.float8_e4m3fn)
            k8, sk = quantize(k, torch.float8_e4m3fn)
            args, scales = (q8, k8, v), {"scale_q": sq, "scale_k": sk}
        out = flash_attention(*args, is_causal=causal, **scales)
        plain = flash_attention_plain(*args, is_causal=causal, **scales)
        # The fp32 oracle on the kernel's own (dequantized) inputs, and on
        # the float inputs before quantization (the fp8 format's own error).
        oracle = sdpa_reference(*args, is_causal=causal, out_dtype=torch.float32, **scales)
        oracle_float = sdpa_reference(q, k, v, is_causal=causal, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = max_abs(out, plain)
        r = rmse(out, oracle)
        r_float = rmse(out, oracle_float)
        finite = bool(torch.isfinite(out).all())
        rec = {"B": b, "S": s, "D": d, "mode": mode, "causal": causal,
               "max_abs_vs_plain": err, "rmse_vs_oracle": r,
               "rmse_vs_float_oracle": r_float}
        if (b, s, mode, causal, d) in ((1, 1536, "head", True, 128), (4, 1536, "head", True, 128)):
            rec["ms"] = time_ms(lambda: flash_attention(*args, is_causal=causal, **scales))
            rec["plain_ms"] = time_ms(lambda: flash_attention_plain(*args, is_causal=causal, **scales), iters=5)
            flops = 4 * b * 32 * s * s * d / (2 if causal else 1)
            rec["kernel_tflops"] = flops / rec["ms"] / 1e9
            if b == 1:
                timing = rec
        log("k1 " + json.dumps(rec))
        if (not finite or err > KERNEL_VS_PLAIN_ATOL or not r < RMSE_BAR
                or (s >= FLOAT_BAR_MIN_SEQ and not r_float < RMSE_BAR)):
            raise RuntimeError(f"K1 disagrees: {rec}")
        worst = max(worst, err)
        del q, k, v, args, out, plain, oracle, oracle_float
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": timing["ms"], "plain_ms": timing["plain_ms"]}


def phase_k4(gen) -> dict:
    """K4 against its plain version and the fp32 oracle."""
    b, hq, hkv, s_max, d = 4, 32, 8, 2048, 128
    lens = [0, 57, 900, 2047]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    worst = 0.0
    timing = None
    for cache_dtype in (torch.int8, torch.bfloat16):
        q = _randn((b, hq, d), gen)
        kf = _randn((b, hkv, s_max, d), gen)
        vf = _randn((b, hkv, s_max, d), gen)
        if cache_dtype == torch.int8:
            kc, ks = quant.dynamically_quantize_int8(kf, reduction_dim=-1)
            vc, vs = quant.dynamically_quantize_int8(vf, reduction_dim=-1)
            kd, vd = quant.dequantize(kc, ks), quant.dequantize(vc, vs)
        else:
            kc, vc, ks, vs = kf, vf, None, None
            kd, vd = kf.float(), vf.float()
        out = decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs)
        plain = decode_attention_plain(q, kc, vc, lengths, ks, vs)
        oracle = torch.zeros((b, hq, d), device="cuda")
        for i, n in enumerate(lens):
            if n:
                oracle[i] = sdpa_reference(
                    q[i : i + 1, :, None, :], kd[i : i + 1, :, :n], vd[i : i + 1, :, :n],
                    out_dtype=torch.float32,
                )[0, :, 0, :]
        torch.cuda.synchronize()
        err = max_abs(out, plain)
        r = rmse(out, oracle)
        rec = {"cache": str(cache_dtype).split(".")[-1], "lengths": lens,
               "max_abs_vs_plain": err, "rmse_vs_oracle": r,
               "zero_row_exact": bool((out[0] == 0).all())}
        rec["ms"] = time_ms(lambda: decode_attention(q, kc, vc, lengths, k_scale=ks, v_scale=vs))
        rec["plain_ms"] = time_ms(lambda: decode_attention_plain(q, kc, vc, lengths, ks, vs), iters=5)
        cache_bytes = sum(lens) * hkv * d * 2 * kc.element_size()
        rec["kernel_GBps"] = cache_bytes / rec["ms"] / 1e6
        log("k4 " + json.dumps(rec))
        if (not bool(torch.isfinite(out).all()) or err > KERNEL_VS_PLAIN_ATOL
                or not r < RMSE_BAR or not rec["zero_row_exact"]):
            raise RuntimeError(f"K4 disagrees: {rec}")
        worst = max(worst, err)
        if cache_dtype == torch.int8:
            timing = rec
    return {"max_abs_err": worst, "ms": timing["ms"], "plain_ms": timing["plain_ms"]}


def phase_k1_residuals(gen) -> dict:
    """K1's (m, l) against their plain version; the output is unchanged."""
    cases = [(1, 57, "bf16", True, 128), (4, 1536, "bf16", True, 128),
             (1, 512, "bf16", False, 128), (1, 512, "head", True, 128),
             (1, 512, "bf16", True, 64)]
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
        log("k1_residuals " + json.dumps(rec))
        if (not bool(torch.isfinite(m).all() and torch.isfinite(l).all())
                or not rec["m_max_abs_vs_plain"] <= RESIDUAL_M_ATOL
                or not rec["l_max_rel_vs_plain"] <= RESIDUAL_L_RTOL
                or not rec["out_equal_without_residuals"]):
            raise RuntimeError(f"K1 residuals disagree: {rec}")
        worst["m_abs"] = max(worst["m_abs"], rec["m_max_abs_vs_plain"])
        worst["l_rel"] = max(worst["l_rel"], rec["l_max_rel_vs_plain"])
        del q, k, v, args, out, bare, m, l, pm, pl
    torch.cuda.empty_cache()
    return worst


def _oracle_grads(q, k, v, do, causal):
    """(dq, dk, dv) by autograd of the fp32 oracle."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = sdpa_reference(*leaves, is_causal=causal, out_dtype=torch.float32)
    return torch.autograd.grad(out, leaves, do.float())


def phase_k23(gen) -> dict:
    """K2 and K3 against their plain version and the fp32 oracle's autograd."""
    cases = [(b, s, causal, 128) for b in (1, 4) for s in (57, 512, 1536)
             for causal in (True, False)]
    cases.append((1, 512, True, 64))
    worst = {"dq": 0.0, "dkv": 0.0}
    timing = None
    for b, s, causal, d in cases:
        q = _randn((b, 32, s, d), gen)
        k = _randn((b, 8, s, d), gen)
        v = _randn((b, 8, s, d), gen)
        do = _randn((b, 32, s, d), gen)
        out, (m, l) = flash_attention(q, k, v, is_causal=causal, return_residuals=True)
        grads = flash_attention_bwd(q, k, v, out, do, m, l, is_causal=causal)
        plain = flash_attention_bwd_plain(q, k, v, out, do, m, l, is_causal=causal)
        oracle = _oracle_grads(q, k, v, do, causal)
        torch.cuda.synchronize()
        rec = {"B": b, "S": s, "D": d, "causal": causal}
        for name, g, p, o in zip(("dq", "dk", "dv"), grads, plain, oracle):
            rec[f"{name}_rel_vs_plain"] = max_rel(g, p)
            rec[f"{name}_rel_vs_oracle"] = max_rel(g, o)
            rec[f"{name}_max_abs_vs_plain"] = max_abs(g, p)
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"K2/K3 gave non-finite {name}: {rec}")
        if (b, s, causal, d) in ((1, 1536, True, 128), (4, 1536, True, 128)):
            delta = row_delta(out, do)
            args = (q, k, v, do, m, l, delta)
            rec["dq_ms"] = time_ms(lambda: flash_bwd_dq(*args, is_causal=causal))
            rec["dkv_ms"] = time_ms(lambda: flash_bwd_dkv(*args, is_causal=causal))
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
        if bad:
            raise RuntimeError(f"K2/K3 disagree ({bad}): {rec}")
        worst["dq"] = max(worst["dq"], rec["dq_max_abs_vs_plain"])
        worst["dkv"] = max(worst["dkv"], rec["dk_max_abs_vs_plain"], rec["dv_max_abs_vs_plain"])
        del q, k, v, do, out, m, l, grads, plain, oracle
    torch.cuda.empty_cache()
    return {
        "dq": {"max_abs_err": worst["dq"], "ms": timing["dq_ms"], "plain_ms": timing["dq_plain_ms"]},
        "dkv": {"max_abs_err": worst["dkv"], "ms": timing["dkv_ms"],
                "plain_ms": timing["dkv_plain_ms"]},
    }


def phase_engine():
    """Llama-3-8B, full width and depth, random bf16 weights, 6 requests."""
    cfg = llama.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator("cuda").manual_seed(0), cfg, "cuda")
    torch.cuda.synchronize()
    log(f"engine init_params_s={time.perf_counter() - t0:.3f} "
        f"weights_GB={torch.cuda.memory_allocated() / 1e9:.3f}")
    eng = Engine(params, cfg, num_slots=4, max_len=2048, cache_dtype=torch.int8,
                 device="cuda")
    rng = np.random.default_rng(0)
    prompt_lens = [57, 128, 300, 300, 900, 1500]
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   max_new_tokens=int(rng.integers(16, 33)))
        for n in prompt_lens
    ]

    backend = eng._backend
    timers = {"prefill_s": 0.0, "decode_s": 0.0}
    prefills = []
    orig_prefill, orig_decode = backend.prefill_and_write, backend.decode

    def timed_prefill(prefill_fn, params_, tokens, last_pos, *rest):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = orig_prefill(prefill_fn, params_, tokens, last_pos, *rest)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t
        prefills.append((tokens.clone(), list(last_pos), logits.clone()))
        return logits

    def timed_decode(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = orig_decode(*args)
        torch.cuda.synchronize()
        timers["decode_s"] += time.perf_counter() - t
        return logits

    backend.prefill_and_write = timed_prefill
    backend.decode = timed_decode

    flash_attention.launches = 0
    decode_attention.launches = 0
    dispatch.sdpa_fallback.calls = 0
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": flash_attention.launches, "k4": decode_attention.launches,
                "sdpa_fallback": dispatch.sdpa_fallback.calls}
    stats = dict(eng.stats)
    decode_tokens = stats["generated_tokens"] - len(reqs)
    rec = {
        "stats": stats, "launches": launches, "wall_s": wall,
        "prefill_tok_s": stats["prefill_tokens"] / timers["prefill_s"],
        "decode_tok_s": decode_tokens / timers["decode_s"],
        "decode_ms_per_step": 1e3 * timers["decode_s"] / stats["decode_steps"],
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("engine " + json.dumps(rec))

    for r in reqs:
        if not r.done or len(r.output) != r.max_new_tokens:
            raise RuntimeError(f"request {r.id} ended with {len(r.output)} of {r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise RuntimeError(f"request {r.id} produced out-of-vocabulary tokens")
    L = cfg.num_layers
    if launches["k1"] < L * stats["prefill_forwards"]:
        raise RuntimeError(f"K1 ran {launches['k1']} times for {stats['prefill_forwards']} prefills")
    if launches["k4"] < L * stats["decode_steps"]:
        raise RuntimeError(f"K4 ran {launches['k4']} times for {stats['decode_steps']} decode steps")
    if launches["sdpa_fallback"] != 0:
        raise RuntimeError("the main path fell back to SDPA")

    # Each prefill's last-position logits against a plain-attention run.
    plain_cfg = llama.llama3_8b(attention_impl="sdpa")
    worst = 0.0
    for tokens, last_pos, logits in prefills:
        ref, _ = llama.forward_prefill(
            params, tokens, plain_cfg,
            last_pos=torch.tensor(last_pos, device="cuda"),
        )
        if not bool(torch.isfinite(logits).all()) or logits.shape != ref.shape:
            raise RuntimeError("prefill logits are not finite or have the wrong shape")
        rel = (torch.linalg.vector_norm(logits - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1))
        agree = (logits.argmax(-1) == ref.argmax(-1)).tolist()
        log(f"engine prefill width={tokens.shape[1]} rows={tokens.shape[0]} "
            f"rel_err={rel.tolist()} argmax_agree={agree}")
        worst = max(worst, float(rel.max()))
    log(f"engine prefill worst_rel_err={worst} bound={PREFILL_REL_BOUND}")
    if not worst < PREFILL_REL_BOUND:
        raise RuntimeError(f"prefill logits off by {worst} relative")
    return launches, params


def _checked_grads(params, tokens, impl):
    """Gradients of the leaves the training phase compares, at
    GRAD_CHECK_LAYERS layers."""
    cut = {**params, "layers": params["layers"][:GRAD_CHECK_LAYERS]}
    cfg = llama.llama3_8b(num_layers=GRAD_CHECK_LAYERS, attention_impl=impl)
    _, grads = llama.loss_and_grads(cut, tokens, cfg)
    first, last = grads["layers"][0], grads["layers"][-1]
    return {"embed": grads["embed"], "layers.0.wq": first["wq"], "layers.0.wk": first["wk"],
            "layers.0.wv": first["wv"], f"layers.{GRAD_CHECK_LAYERS - 1}.w_down": last["w_down"]}


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

    flash_attention.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    dispatch.sdpa_fallback.calls = 0
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
    launches = {"k1": flash_attention.launches, "k2": flash_bwd_dq.launches,
                "k3": flash_bwd_dkv.launches, "sdpa_fallback": dispatch.sdpa_fallback.calls}
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


def main() -> int:
    if not checks.cuda_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"card {smi}")
    env = phase_env()
    gen = torch.Generator("cuda").manual_seed(0)
    k1 = phase_k1(gen)
    k4 = phase_k4(gen)
    phase_k1_residuals(gen)
    k23 = phase_k23(gen)
    launches, params = phase_engine()
    train = phase_train(params)
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["k1"], **k1},
        {"name": "decode", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": launches["k4"], **k4},
        {"name": "flash_bwd_dq", "route": "cuda", "source": K23_SOURCE,
         "replaces": K2_REPLACES, "launches": train["k2"], **k23["dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": K23_SOURCE,
         "replaces": K3_REPLACES, "launches": train["k3"], **k23["dkv"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device"], "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
