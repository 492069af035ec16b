"""Serving cells: the engine (``serving/engine.Engine``) driven through its
public calls, ``submit(..., on_token=)`` and ``run_to_completion(
decode_burst=)``, by a closed loop of waves (``traffic/<kind>.py``).

Set-up: weights drawn from the seed on the card by the configuration's
family (``perfbench/families/``), the program's own preparation of them
(``fuse_projections`` for the fused format), the engine, then one warm-up
wave of the cell's traffic cut short (``warm_up_wave``), so that the prefill shapes, kernels, library handles
and burst graph the window meets exist before it opens (a graph captured
inside the window is reported on standard error).

The window runs waves until ``--seconds`` have passed, the last one to its
end: it lasts from the first wave's submission to the last one's finish.
Each request records its submission, the host time of each ``on_token``
call and its token count.  Traced runs profile the window's second wave
with the harness's spans around the engine's calls into its backend: the
whole wave, or where the cell gives ``traced_steps`` [a, b], the stretch
from the call that begins at its a-th decode step to the one that begins
at its b-th (a wave longer than a trace should hold).

After the window: the peak memory, then the program's state is freed and
a sample of the finished requests drawn from the seed, the longest among
them, is run through the family's float32 reference with its served
tokens; the widest gap by which a served token's logit lies below the
reference's best decides ``correct`` with every request's completeness.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
import types
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench import spec
from perfbench import trace as trace_lib
from perfbench.traffic import load as load_traffic

PREFILL, DECODE, BURST = "prefill step", "eager decode step", "burst"
TRACED_WAVE = 1  # the window's wave that a traced run profiles: its second
DECODE_SPANS = (DECODE, BURST)
PREFILL_SPANS = (PREFILL,)


def build_engine(cell: Dict, cfg, seed: int, device):
    from quantumattention_tpu_torch.models import quantized
    from quantumattention_tpu_torch.serving.engine import Engine

    fmt = cell["weights"]
    if fmt not in ("int8", "int8-fused"):
        raise ValueError(f"unknown serving weight format {fmt!r}")
    tree = spec.family(cell["model"]).int8_tree(cfg, seed, device)
    if fmt == "int8-fused":
        tree = quantized.fuse_projections(tree)
    e = cell["engine"]
    return Engine(tree, cfg, num_slots=e["num_slots"], max_len=e["max_len"], cache_dtype=torch.int8,
                  prefill_bucket=e.get("prefill_bucket", 128), device=device)


class Request:
    """What the harness keeps of one request: its prompt, budget, the
    engine's request object, and the host times of its tokens."""

    __slots__ = ("prompt", "new", "req", "submit", "first", "last", "n")

    def __init__(self, prompt, new) -> None:
        self.prompt, self.new = prompt, new
        self.req = None
        self.submit = self.first = self.last = None
        self.n = 0

    def on_token(self, _tok, _req) -> None:
        t = time.perf_counter()
        if self.first is None:
            self.first = t
        self.last = t
        self.n += 1


def warm_up_wave(wave, burst: int, slots: Optional[int] = None):
    """The wave's first ``slots`` requests (a wave that queues past the
    slots meets no shape its first slots-full does not) with each request's
    tokens cut to what warms every shape the window meets: its prompts whole
    (the same prefill forwards), one eager decode step after each forward
    (at most one a request), then a first burst of the full ``burst`` steps,
    which captures the burst graph at the size every later burst replays
    within."""
    wave = wave[:slots]
    cap = len(wave) + burst + 1
    return [(p, min(n, cap)) for p, n in wave]


def run_wave(eng, wave, burst: int) -> List[Request]:
    out = [Request(p, n) for p, n in wave]
    t = time.perf_counter()
    for r in out:
        r.submit = t
        r.req = eng.submit(r.prompt, max_new_tokens=r.new, on_token=r.on_token)
    eng.run_to_completion(decode_burst=burst)
    return out


class Recorder:
    """The profiler, with spans and work records of the engine's calls into
    its backend, over a traced wave (installed on the backend instance,
    removed after): the whole wave, or given ``steps`` (a, b), from before
    the first call that begins at the wave's a-th decode step or later to
    before the first that begins at its b-th or later."""

    NAMES = ("prefill_and_write", "decode", "burst")

    def __init__(self, eng, steps: Optional[Sequence[int]] = None) -> None:
        self.eng, self.backend = eng, eng._backend
        self.calls: List[Dict] = []
        self._orig = {}
        self.steps = steps
        self.step = 0  # decode steps of the wave before the current call
        self.on = steps is None
        self.trace_path = None
        self._profile = contextlib.ExitStack()

    def _stretch(self) -> None:
        if self.steps is None:
            return
        if self.trace_path is None and self.step >= self.steps[0]:
            self.trace_path = self._profile.enter_context(trace_lib.profiled(True))
            self.on = True
        if self.on and self.step >= self.steps[1]:
            self._profile.close()
            self.on = False

    def _lengths(self) -> Dict[int, int]:
        """Each active slot's cache length once this step has appended."""
        return {slot: len(r.prompt) + len(r.output) for slot, r in self.eng.active.items()}

    def __enter__(self):
        if self.on:
            self.trace_path = self._profile.enter_context(trace_lib.profiled(True))
        b = self.backend
        self._orig = {n: getattr(b, n) for n in self.NAMES}
        cuda = b.device.type == "cuda"

        def prefill(*args):
            self._stretch()
            if not self.on:
                return self._orig["prefill_and_write"](*args)
            with torch.profiler.record_function(PREFILL):
                t = time.perf_counter()
                out = self._orig["prefill_and_write"](*args)
                if cuda:
                    torch.cuda.synchronize()
                self.calls.append({"kind": "prefill", "host_s": time.perf_counter() - t,
                                   "prompt_lens": list(args[5])})
            return out

        def decode(*args):
            self._stretch()
            self.step += 1
            if not self.on:
                return self._orig["decode"](*args)
            steps = [list(self._lengths().values())]
            with torch.profiler.record_function(DECODE):
                out = self._orig["decode"](*args)
            self.calls.append({"kind": "decode", "steps": steps})
            return out

        def burst(*args):
            self._stretch()
            remaining, n = args[3], args[6]
            self.step += n
            if not self.on:
                return self._orig["burst"](*args)
            lengths = self._lengths()
            steps = [[n0 + j for s, n0 in lengths.items() if j < remaining[s]] for j in range(n)]
            with torch.profiler.record_function(BURST):
                t = time.perf_counter()
                out = self._orig["burst"](*args)
                self.calls.append({"kind": "burst", "host_s": time.perf_counter() - t, "steps": steps})
            return out

        b.prefill_and_write, b.decode, b.burst = prefill, decode, burst
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.backend, n, fn)
        self._profile.close()
        return False


def _counters(eng) -> Dict[str, int]:
    return {**eng.stats, **eng._backend.stats}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def sample_requests(records: List[Request], k: int, seed: int) -> List[Request]:
    """The finished request with the longest prompt and served tokens,
    then k - 1 more drawn from the seed."""
    done = [r for r in records if r.req.done and r.req.output]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + len(done[i].req.output))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def reference_gaps(model: Dict, seed: int, sample: List[Request], device, variants=None):
    """Per variant, per sampled request, the gaps at its served positions:
    for "ref" how far each served token's logit lies below the reference's
    best; for any other variant, the reference's gap of the token that
    variant puts first."""
    fam = spec.family(model)
    ref = fam.reference
    sizes = fam.sizes(model)
    seqs = [list(r.prompt) + list(r.req.output[:-1]) for r in sample]
    pos = [range(len(r.prompt) - 1, len(r.prompt) + len(r.req.output) - 1) for r in sample]
    logits = ref.logits_at(
        ref.shape_of(model["config"]), seqs, pos, fam.int8_top(sizes, seed, device),
        lambda i: fam.int8_layer(sizes, i, seed, device), variants=variants)
    out = {"ref": [ref.served_gaps(lg, r.req.output) for lg, r in zip(logits["ref"], sample)]}
    for name, per_seq in logits.items():
        if name != "ref":
            out[name] = [ref.chosen_gaps(a, b) for a, b in zip(logits["ref"], per_seq)]
    return out


def gap_readings(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap of a served token
    below the reference's best, and the mean gap over the served tokens
    (steady where rounding alone flips a token now and then, as near-tied
    expert choices do in a random MoE model)."""
    if not gaps.numel():
        return {"gap_max": float("inf"), "gap_mean": float("inf")}
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean())}


def run(cell: Dict, cfg, seed: int, seconds: float, traced: bool, t_process: float,
        device="cuda") -> Dict:
    device = torch.device(device)
    cuda = device.type == "cuda"
    phases = {"imports": time.time() - t_process}
    t = time.perf_counter()
    eng = build_engine(cell, cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["weights_and_engine"] = time.perf_counter() - t
    gen = load_traffic(cell["traffic"], cfg.vocab_size, seed)
    burst = cell["engine"]["decode_burst"]
    t = time.perf_counter()
    run_wave(eng, warm_up_wave(gen.wave(-1), burst, cell["engine"]["num_slots"]), burst)
    if cuda:
        torch.cuda.synchronize()
    phases["warm_up"] = time.perf_counter() - t
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=sys.stderr)

    records: List[Request] = []
    rec = None
    trace_path = None
    before = _counters(eng)
    t0 = time.perf_counter()
    setup_s = time.time() - t_process
    index = 0
    wave_s = []
    while True:
        t_wave = time.perf_counter()
        if traced and index == TRACED_WAVE:
            with Recorder(eng, cell.get("traced_steps")) as rec:
                records += run_wave(eng, gen.wave(index), burst)
            trace_path = rec.trace_path
            if trace_path is None:
                raise ValueError(f"traced_steps {cell['traced_steps']} begin past the wave's {rec.step} decode steps")
        else:
            records += run_wave(eng, gen.wave(index), burst)
        wave_s.append(time.perf_counter() - t_wave)
        index += 1
        if time.perf_counter() - t0 >= seconds and (index > TRACED_WAVE or not traced):
            break
    window_s = time.perf_counter() - t0
    counters = {k: v - before[k] for k, v in _counters(eng).items()}
    if counters.get("graph_captures"):
        print(f"warning: {counters['graph_captures']} burst graph capture(s) inside the window",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    tokens = sum(r.n for r in records)
    ttft = [1e3 * (r.first - r.submit) for r in records if r.first is not None]
    tpot = [1e3 * (r.last - r.first) / (r.n - 1) for r in records if r.n > 1]
    e2e = {"output_tok_s": tokens / window_s, "ttft_p95_ms": percentile(ttft, 95),
           "tpot_p95_ms": percentile(tpot, 95), "setup_s": setup_s}
    print(f"window: {len(records)} requests in {index} waves, {tokens} tokens, {window_s:.3f} s; "
          f"ttft p50 {percentile(ttft, 50):.1f} ms, tpot p50 {percentile(tpot, 50):.2f} ms "
          f"({len(ttft)} and {len(tpot)} samples); waves " + " ".join(f"{w:.3f}" for w in wave_s) + " s",
          file=sys.stderr)

    ctx = None
    if traced:
        t_parse = time.perf_counter()
        size = os.path.getsize(trace_path)
        tr = trace_lib.Trace(trace_path, DECODE_SPANS + PREFILL_SPANS)
        os.unlink(trace_path)
        print(f"trace: {size / 1e6:.0f} MB, {tr.events} events, {len(tr.ops)} device ops, read in "
              f"{time.perf_counter() - t_parse:.1f} s", file=sys.stderr)
        ctx = types.SimpleNamespace(cfg=cfg, cell=cell, wave=TRACED_WAVE, counters=counters, calls=rec.calls,
                                    trace=tr, DECODE_SPANS=DECODE_SPANS, PREFILL_SPANS=PREFILL_SPANS)

    incomplete = [r for r in records if not r.req.done or len(r.req.output) != r.new or r.n != r.new]
    sample = sample_requests(records, cell["check"]["sample_requests"], seed)
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per_request = reference_gaps(cell["model"], seed, sample, device)["ref"]
    gaps = torch.cat(per_request) if per_request else torch.zeros(0)
    readings = gap_readings(gaps)
    print(f"reference: {len(sample)} requests, {gaps.numel()} served tokens, "
          f"{int((gaps > 0).sum())} off the reference's argmax, gap max {readings['gap_max']:.4f} "
          f"mean {readings['gap_mean']:.4f}, {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    check = cell["check"]
    checks = {
        check["compare"]: {"value": readings[check["compare"]], "limit": check["limit"]},
        "incomplete_requests": {"value": len(incomplete), "limit": 0},
        "compared_tokens": {"value": int(gaps.numel()), "limit": check["min_compared_tokens"]},
    }
    correct = (readings[check["compare"]] <= check["limit"] and not incomplete
               and gaps.numel() >= check["min_compared_tokens"])
    return {"correct": bool(correct), "attempted": len(records), "failed": len(incomplete), "e2e": e2e,
            "ctx": ctx, "memory_peak_bytes": peak, "checks": checks}
