"""The port's autotuner (mirrors tests/test_autotune.py) and its two users:
the "auto" path sweep (dispatch) and K1's tile configuration (ops/flash).

Every test writes its cache under ``tmp_path`` (QUANTUM_ATTN_CACHE_DIR).
On the CPU nothing is timed on a device: the sweep tests time host
callables or replace the timer.
"""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

import quantumattention_tpu_torch as qt
from quantumattention_tpu_torch import autotune, config, dispatch
from quantumattention_tpu_torch.ops import flash


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QUANTUM_ATTN_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    for name in ("sweeps", "timed", "hits", "misses_in_capture"):
        monkeypatch.setattr(autotune, name, 0)
    monkeypatch.setattr(autotune, "last_sweeps", {})
    yield


def test_shape_key_buckets_long_sequences():
    k1 = autotune.shape_key("flash", 1, 8, 8, 5000, 5000, 128, True, torch.bfloat16, "cpu")
    k2 = autotune.shape_key("flash", 1, 8, 8, 6000, 6000, 128, True, torch.bfloat16, "cpu")
    k3 = autotune.shape_key("flash", 1, 8, 8, 9000, 9000, 128, True, torch.bfloat16, "cpu")
    assert k1 == k2  # both bucket to 8192
    assert k1 != k3  # 16384 bucket
    assert k1 == "cpu|flash|b1h8kv8|sq8192skv8192d128|c1|bfloat16"


@pytest.mark.parametrize("n,bucket", [(1, 1), (57, 57), (1024, 1024), (1025, 2048), (8192, 8192)])
def test_bucket_exact_up_to_1k(n, bucket):
    assert autotune._bucket(n) == bucket


def test_device_name_in_key(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    key = autotune.shape_key("path", 1, 32, 8, 1536, 1536, 128, True, torch.bfloat16,
                             torch.device("cuda"))
    assert key.startswith("NVIDIA_H100_80GB_HBM3|path|")
    assert autotune.device_name("cpu") == "cpu"


def test_prune_respects_smem():
    assert autotune.smem_fits(192, 64, 128)
    assert autotune.smem_fits(128, 128, 128)
    assert autotune.smem_fits(64, 32, 512)
    assert not autotune.smem_fits(256, 256, 128)
    assert not autotune.smem_fits(128, 128, 128, limit=160 * 1024)
    # 8-bit Q/K halve their tiles.
    assert autotune.k1_smem_bytes(128, 128, 128, 1) < autotune.k1_smem_bytes(128, 128, 128, 2)
    cands = autotune.prune_candidates(8192, 8192, 128)
    assert cands == [(192, 64), (128, 128)]
    assert all(autotune.smem_fits(bq, bkv, 128) for bq, bkv in cands)


def test_prune_shrinks_for_short_seqs():
    assert autotune.prune_candidates(64, 64, 128) == [(128, 128)]
    assert autotune.prune_candidates(57, 900, 64, 1) == [(128, 128)]
    for q_len in (1, 64, 100, 300):
        cands = autotune.prune_candidates(q_len, q_len, 128)
        assert cands and all(bq <= 2 * max(q_len, 64) or len(cands) == 1 for bq, _ in cands)
    # One configuration at widths 256 and 512.
    assert autotune.prune_candidates(4096, 4096, 256) == [(128, 32)]
    assert autotune.prune_candidates(4096, 4096, 320) == [(64, 32)]


def test_tune_caches_winner():
    calls = []

    def runner(c):
        def run():
            calls.append(c)
            time.sleep(0.002 if c == (128, 128) else 0.01)

        return run

    key = "test|key"
    best = autotune.tune(key, [(128, 128), (256, 256)], runner, "cpu")
    assert best == (128, 128)
    assert json.loads(autotune.cache_path().read_text())[key] == [128, 128]
    assert autotune.sweeps == 1 and autotune.timed == 2
    assert set(autotune.last_sweeps[key]) == {"[128, 128]", "[256, 256]"}
    # A second call times nothing.
    n = len(calls)
    assert autotune.tune(key, [(128, 128), (256, 256)], runner, "cpu") == (128, 128)
    assert len(calls) == n and autotune.timed == 2 and autotune.hits == 1


def test_tune_skips_failing_candidates():
    def runner(c):
        def run():
            if c == "broken":
                raise RuntimeError("launch refused")

        return run

    assert autotune.tune("test|fail", ["broken", "fine"], runner, "cpu") == "fine"
    assert autotune.lookup_value("test|fail") == "fine"
    assert autotune.last_sweeps["test|fail"]["broken"].startswith("skipped: RuntimeError")
    # Every candidate failing records nothing and returns the first.
    assert autotune.tune("test|none", ["broken"], runner, "cpu") == "broken"
    assert autotune.lookup_value("test|none") is None


def test_tune_raises_where_not_skippable():
    """A candidate whose error ``skippable`` refuses fails the sweep, which
    records nothing, even after a faster candidate ran."""

    def runner(c):
        def run():
            if c == "broken":
                raise RuntimeError("launch refused")

        return run

    with pytest.raises(RuntimeError, match="launch refused"):
        autotune.tune("test|strict", ["fine", "broken"], runner, "cpu",
                      skippable=lambda c, e: False)
    assert autotune.lookup_value("test|strict") is None


def test_pretuned_defaults_merge(tmp_path, monkeypatch):
    """A packaged pretuned table supplies defaults; the user cache wins."""
    fake = tmp_path / "pretuned.json"
    fake.write_text(json.dumps({"dev|flash|shipped": [192, 64], "dev|flash|both": [192, 64]}))
    monkeypatch.setattr(autotune, "_pretuned_path", lambda: fake)
    autotune._CACHE = None
    assert autotune.lookup("dev|flash|shipped") == (192, 64)
    autotune.record("dev|flash|both", 128, 128)
    autotune._CACHE = None
    assert autotune.lookup("dev|flash|both") == (128, 128)
    assert autotune.lookup("dev|flash|shipped") == (192, 64)
    # The port ships an empty table.
    assert json.loads(pathlib.Path(autotune.__file__).with_name("pretuned.json").read_text()) == {}


def test_lookup_value_and_record_value():
    assert autotune.lookup_value("dev|path|x") is None
    autotune.record_value("dev|path|x", "head-wise")
    autotune._CACHE = None  # read back from disk
    assert autotune.lookup_value("dev|path|x") == "head-wise"
    assert autotune.lookup("dev|path|x") is None  # not a block pair


def _qkv(s=96, hq=4, hkv=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, s, d)).astype(np.float32)).to(torch.bfloat16)
            for h in (hq, hkv, hkv)]


def test_auto_on_cpu_is_per_block_untimed():
    q, k, v = _qkv()
    out = qt.fp8_attn_func(q, k, v, is_causal=True, scaling_method="auto")
    want = qt.fp8_attn_func(q, k, v, is_causal=True, scaling_method="per-block")
    assert torch.equal(out, want)
    assert autotune.sweeps == 0 and autotune.timed == 0
    assert not autotune.cache_path().exists()


class _CudaLike:
    """A stand-in for a CUDA tensor's metadata (no card here)."""

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device("cuda")

    def element_size(self):
        return 2


def test_no_sweep_while_capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    assert not autotune.sweep_allowed(torch.device("cuda"))
    assert autotune.misses_in_capture == 1
    q, k = _CudaLike((1, 32, 1536, 128)), _CudaLike((1, 8, 1536, 128))
    # The "auto" path: the default, untimed.
    assert dispatch._tuned_path(q, k, k, True, None, None) == "per-block"
    # K1's tiles in a per-block call: the default configuration, no launch.
    key = flash._tile_key(q, k, None, True, True, None)
    assert key == "card|flash-block|b1h32kv8|sq2048skv2048d128|c1|bfloat16"

    def run(tiles):
        raise AssertionError("no launch may be timed under capture")

    assert flash._k1_tiles(key, q, k, True, run) == 0
    assert autotune.misses_in_capture == 3 and autotune.sweeps == 0
    # A cached winner is still taken under capture.
    autotune.record(key, 128, 128)
    assert flash._k1_tiles(key, q, k, True, run) == 1


def test_k1_tiles_sweep_only_where_asked(monkeypatch):
    """Outside per-block calls and ``autotune.tuning()`` a miss keeps the
    default configuration untimed; autotune off skips the cache."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "card")
    q, k = _CudaLike((1, 32, 1536, 128)), _CudaLike((1, 8, 1536, 128))
    key = flash._tile_key(q, k, None, False, True, (255, None))
    assert key == "card|flash-w255_None|b1h32kv8|sq2048skv2048d128|c1|bfloat16"
    timed = []
    monkeypatch.setattr(autotune, "_time", lambda fn, device: (fn(), timed.append(1), 1.0)[2])
    assert flash._k1_tiles(key, q, k, False, None) == 0
    with autotune.tuning():
        assert flash._k1_tiles(key, q, k, False, lambda tiles: tiles) == 0  # a tie keeps the first
    assert len(timed) == 2 and autotune.lookup(key) == (192, 64)
    with config.patch({"kernel.autotune": False}):
        assert flash._tile_key(q, k, None, False, True, None) is None
    assert flash._tile_key(_CudaLike((1, 8, 64, 256)), _CudaLike((1, 8, 64, 256)), None, True,
                           True, None) is None  # one configuration at width 256


def test_sdpa_memory_prune(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (80 * 10**9, 80 * 10**9))
    big = torch.empty((16, 16, 8192, 128), device="meta")
    small = torch.empty((1, 32, 1536, 128), device="meta")
    reason = dispatch.sdpa_prune_reason(big, big)
    assert reason is not None and "68719476736" in reason  # 68.7 GB of fp32 logits
    assert dispatch.sdpa_prune_reason(small, small[:, :8]) is None


def test_path_sweep_records_winner_and_prunes(monkeypatch):
    """The "auto" sweep on CPU tensors with its timer replaced: each path
    runs, the fastest is recorded under JAX's key layout, a pruned "sdpa"
    is named, and a second call times nothing."""
    order = {"none": 3.0, "head-wise": 2.0, "per-block": 1.0, "sdpa": 0.5}
    ran = []

    def fake_time(fn, device):
        fn()
        ran.append(1)
        return order[current[0]]

    current = [None]
    real_runner_tune = autotune.tune

    def tune(key, candidates, runner, device=None, **kw):
        def tracking(c):
            fn = runner(c)
            return lambda: (current.__setitem__(0, c), fn())[1]

        return real_runner_tune(key, candidates, tracking, device, **kw)

    monkeypatch.setattr(autotune, "_time", fake_time)
    monkeypatch.setattr(autotune, "tune", tune)
    monkeypatch.setattr(autotune, "sweep_allowed", lambda device: True)
    monkeypatch.setattr(dispatch, "sdpa_prune_reason", lambda q, k: "too large")
    q, k, v = _qkv()
    assert dispatch._tuned_path(q, k, v, True, None, (16, 0)) == "per-block"
    key = "cpu|path|b1h4kv2|sq96skv96d64|c1|bfloat16|w16_0"
    assert autotune.lookup_value(key) == "per-block"
    assert autotune.last_sweeps[key]["sdpa"] == "pruned: too large"
    assert len(ran) == 3
    monkeypatch.setattr(dispatch, "sdpa_prune_reason", lambda q, k: None)
    assert dispatch._tuned_path(q, k, v, True, None, (16, 0)) == "per-block"
    assert len(ran) == 3  # a hit
    assert dispatch._tuned_path(q, k, v, False, None, None) == "sdpa"
    before = dispatch.sdpa_fallback.calls
    out = qt.fp8_attn_func(q, k, v, scaling_method="auto")
    assert dispatch.sdpa_fallback.calls == before + 1 and out.shape == q.shape


@pytest.mark.parametrize("failing", ["none", "head-wise", "per-block"])
def test_path_sweep_kernel_failure_raises(monkeypatch, failing):
    """A kernel path that raises fails the "auto" sweep and caches nothing,
    so "sdpa" never wins by default; "sdpa" out of memory is skipped."""
    monkeypatch.setattr(autotune, "_time", lambda fn, device: (fn(), 1.0)[1])
    monkeypatch.setattr(autotune, "sweep_allowed", lambda device: True)
    monkeypatch.setattr(dispatch, "sdpa_prune_reason", lambda q, k: None)
    real_flash, real_fp8 = dispatch.flash_attention, dispatch._fp8_forward

    def flash_attention(*args, **kw):
        if failing == "none":
            raise RuntimeError("K1 failed to build")
        return real_flash(*args, **kw)

    def fp8_forward(q, k, v, method, *rest):
        if method == failing:
            raise RuntimeError("K1 failed to launch")
        return real_fp8(q, k, v, method, *rest)

    monkeypatch.setattr(dispatch, "flash_attention", flash_attention)
    monkeypatch.setattr(dispatch, "_fp8_forward", fp8_forward)
    q, k, v = _qkv()
    key = "cpu|path|b1h4kv2|sq96skv96d64|c1|bfloat16"
    with pytest.raises(RuntimeError, match="K1 failed"):
        dispatch._tuned_path(q, k, v, True, None, None)
    assert autotune.lookup_value(key) is None
    with pytest.raises(RuntimeError, match="K1 failed"):
        qt.fp8_attn_func(q, k, v, is_causal=True, scaling_method="auto")


def test_path_sweep_skips_sdpa_out_of_memory(monkeypatch):
    monkeypatch.setattr(autotune, "_time", lambda fn, device: (fn(), 1.0)[1])
    monkeypatch.setattr(autotune, "sweep_allowed", lambda device: True)
    monkeypatch.setattr(dispatch, "sdpa_prune_reason", lambda q, k: None)

    def sdpa_reference(*args, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(dispatch, "sdpa_reference", sdpa_reference)
    q, k, v = _qkv()
    assert dispatch._tuned_path(q, k, v, True, None, None) == "none"  # a tie keeps the first
    key = "cpu|path|b1h4kv2|sq96skv96d64|c1|bfloat16"
    assert autotune.lookup_value(key) == "none"
    assert autotune.last_sweeps[key]["sdpa"].startswith("skipped: OutOfMemoryError")
