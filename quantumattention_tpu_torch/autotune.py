"""Shape-class-keyed autotuner with an on-disk cache (counterpart of
quantumattention_tpu/autotune.py).

The same contract as the JAX package's: a candidate list pruned by a fit
model, a timed sweep run once per shape class, and a JSON cache keyed by
(device, shape class) that later calls and later processes read.  What it
tunes here:

  * the ``"auto"`` path of ``fp8_attention`` (``dispatch._tuned_path``):
    bf16 K1, head-wise e4m3, per-block e4m3 or SDPA, stored under the
    ``"path"`` kind;
  * K1's tile configuration (``ops/flash.py``): Q rows a CTA and KV rows a
    tile, :data:`K1_TILES`, under JAX's ``flash``, ``flash-q2``,
    ``flash-q3`` and ``flash-block`` kinds.

Times are CUDA-event times (``utils/profiling.do_bench``).  No sweep runs
while a CUDA stream is capturing a graph or under ``torch.compile``: a miss
there takes the default and counts in :data:`misses_in_capture`.  JAX's
tracing machinery (``_time_chained``, ``_time_fetch``, ``synth_like``,
``run_outside_trace``, ``kernel.autotune_in_jit``) has no counterpart:
PyTorch runs eagerly.  The packaged ``pretuned.json`` starts empty; the JAX
package's holds TPU winners, which mean nothing on this card.

The cache lives at ``$QUANTUM_ATTN_CACHE_DIR/autotune.json``, else
``~/.cache/quantumattention_tpu_torch/autotune.json``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from . import config
from .utils import profiling, shapes

_LOG = logging.getLogger(__name__)
_CACHE: Optional[Dict[str, object]] = None

#: K1's tile configurations at each instantiated width, (Q rows a CTA, KV
#: rows a tile), the default first; the position is the kernel's ``tiles``
#: argument (csrc/flash_fwd.cuh, ``Cfg``'s V).
K1_TILES: Dict[int, Tuple[Tuple[int, int], ...]] = {
    64: ((192, 128), (128, 128)),
    128: ((192, 64), (128, 128)),
    256: ((128, 32),),
    512: ((64, 32),),
}
#: Shared memory one CTA may use on the H100 (232,448 bytes).
SMEM_PER_CTA = 232448
_STAGES = 2

#: Counters: sweeps run, candidates timed, cache hits, and misses that took
#: the default because a graph was being captured (or torch.compile traced).
sweeps = 0
timed = 0
hits = 0
misses_in_capture = 0
#: The times of each key's last sweep: {key: {candidate: seconds or why skipped}}.
last_sweeps: Dict[str, Dict[str, object]] = {}


def cache_path() -> Path:
    root = os.environ.get(
        "QUANTUM_ATTN_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "quantumattention_tpu_torch"),
    )
    return Path(root) / "autotune.json"


def _pretuned_path() -> Path:
    return Path(__file__).parent / "pretuned.json"


def _load_cache() -> Dict[str, object]:
    """The user's cache merged over the packaged ``pretuned.json`` (the
    user's entries win)."""
    global _CACHE
    if _CACHE is None:
        try:
            base = json.loads(_pretuned_path().read_text())
        except (OSError, ValueError):
            base = {}
        try:
            base.update(json.loads(cache_path().read_text()))
        except (OSError, ValueError):
            pass
        _CACHE = base
    return _CACHE


def _save_cache() -> None:
    if _CACHE is None:
        return
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(_CACHE, indent=1, sort_keys=True))
    except OSError:  # the cache is best-effort
        pass


def _bucket(n: int) -> int:
    """Sequence-length bucket: exact up to 1k, then powers of two."""
    if n <= 1024:
        return n
    b = 1024
    while b < n:
        b *= 2
    return b


def device_name(device=None) -> str:
    """The key's device: ``torch.cuda.get_device_name`` with "_" for
    spaces, or "cpu" (a CPU tensor, or no card)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_")


def shape_key(kind: str, batch: int, heads: int, kv_heads: int, q_len: int, kv_len: int,
              head_dim: int, causal: bool, dtype, device=None) -> str:
    dtype_name = str(dtype).rsplit(".", 1)[-1]
    return (
        f"{device_name(device)}|{kind}|b{batch}h{heads}kv{kv_heads}"
        f"|sq{_bucket(q_len)}skv{_bucket(kv_len)}d{head_dim}"
        f"|c{int(causal)}|{dtype_name}"
    )


def k1_smem_bytes(block_q: int, block_kv: int, head_dim: int, qk_bytes: int = 2) -> int:
    """K1's shared memory at a tile configuration (``Cfg::kSmem``): Q, a
    two-stage ring of K and of 16-bit V tiles, the column scales, the
    barriers and 1 KB of alignment slack."""
    width = shapes.kernel_width(head_dim)
    out_cols = min(width, 256)
    q = block_q * width * qk_bytes
    k = block_kv * width * qk_bytes
    v = block_kv * out_cols * 2
    return q + _STAGES * (k + v) + _STAGES * block_kv * 4 + (1 + 3 * _STAGES) * 8 + 1024


def smem_fits(block_q: int, block_kv: int, head_dim: int, qk_bytes: int = 2,
              limit: int = SMEM_PER_CTA) -> bool:
    """The shared-memory fit model (JAX's ``vmem_fits`` for the card)."""
    return k1_smem_bytes(block_q, block_kv, head_dim, qk_bytes) <= limit


def prune_candidates(q_len: int, kv_len: int, head_dim: int, qk_bytes: int = 2,
                     candidates: Optional[Sequence[Tuple[int, int]]] = None) -> List[Tuple[int, int]]:
    """K1's tile configurations at ``head_dim``'s width that fit shared
    memory and are not more than twice the sequence (a 192-row Q block
    over 64 queries is mostly padding); never empty."""
    if candidates is None:
        candidates = K1_TILES[shapes.kernel_width(head_dim)]
    out = [
        (bq, bkv) for bq, bkv in candidates
        if bq <= 2 * max(q_len, 64) and bkv <= 2 * max(kv_len, 64)
        and smem_fits(bq, bkv, head_dim, qk_bytes)
    ]
    return out or [tuple(candidates[-1])]


def _capturing() -> bool:
    compiler = getattr(torch, "compiler", None)
    if compiler is not None and getattr(compiler, "is_compiling", lambda: False)():
        return True
    return bool(torch.cuda.is_current_stream_capturing())


_requests = 0


@contextlib.contextmanager
def tuning() -> Iterator[None]:
    """Calls inside sweep K1's tile configuration on a miss whatever their
    kind; outside, only per-block calls do (ops/flash.py)."""
    global _requests
    _requests += 1
    try:
        yield
    finally:
        _requests -= 1


def tuning_requested() -> bool:
    return _requests > 0


def sweep_allowed(device) -> bool:
    """Whether a miss on ``device`` may run a timed sweep: autotune on, a
    CUDA device, and no graph capture or ``torch.compile`` trace in
    progress (such a miss is counted in :data:`misses_in_capture`)."""
    global misses_in_capture
    if not config.kernel.autotune or torch.device(device).type != "cuda":
        return False
    if _capturing():
        misses_in_capture += 1
        return False
    return True


def lookup(key: str) -> Optional[Tuple[int, int]]:
    global hits
    hit = _load_cache().get(key)
    if isinstance(hit, list) and len(hit) == 2:
        hits += 1
        return tuple(hit)  # type: ignore[return-value]
    return None


def record(key: str, block_q: int, block_kv: int) -> None:
    _load_cache()[key] = [block_q, block_kv]
    _save_cache()


def lookup_value(key: str):
    """Raw cache access for non-block entries (the path choices)."""
    global hits
    hit = _load_cache().get(key)
    if hit is not None:
        hits += 1
    return hit


def record_value(key: str, value) -> None:
    _load_cache()[key] = value
    _save_cache()


def _time(fn: Callable[[], object], device) -> float:
    return profiling.do_bench(fn, iters=5, warmup=1, reps=3, device=device)


def tune(key: str, candidates: Sequence, runner: Callable[[object], Callable[[], object]],
         device=None, skippable: Callable[[object, Exception], bool] = lambda c, e: True):
    """Time ``runner(c)()`` for each candidate ``c`` once (a hit returns
    the cached winner with no timing), record and return the fastest.  A
    candidate that raises is skipped and logged where ``skippable(c, e)``
    says so (by default always, as JAX's ``tune``); otherwise the error
    propagates and nothing is recorded.  Candidates are block pairs
    (stored as lists) or strings.  When every candidate raises, the first
    is returned and nothing is recorded."""
    global sweeps, timed
    hit = lookup_value(key)
    if hit is not None:
        return tuple(hit) if isinstance(hit, list) else hit
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    sweeps += 1
    times: Dict[str, object] = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        label = str(list(cand) if isinstance(cand, tuple) else cand)
        try:
            t = _time(runner(cand), device)
        except Exception as e:  # a candidate that cannot run is skipped
            if not skippable(cand, e):
                raise
            times[label] = f"skipped: {type(e).__name__}: {e}"[:200]
            _LOG.warning("autotune %s: candidate %s skipped: %s", key, label, e)
            continue
        timed += 1
        times[label] = t
        if t < best_t:
            best, best_t = cand, t
    last_sweeps[key] = times
    if best is None:
        return candidates[0]
    record_value(key, list(best) if isinstance(best, tuple) else best)
    return best
