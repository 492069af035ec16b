"""The port's timing helpers (``utils/profiling``) on the CPU: the FLOP
model equals the JAX package's, the timers return positive seconds from
the host's clock, and ``trace`` writes its trace."""

import os

import pytest
import torch

from quantumattention_tpu.utils import profiling as jprof
from quantumattention_tpu_torch.utils import profiling


@pytest.mark.parametrize("shape", [
    (1, 32, 1536, 1536, 128, True),
    (16, 16, 8192, 8192, 64, False),
    (4, 32, 1, 2048, 128, False),   # a decode step
    (3, 8, 5, 700, 96, True),
])
def test_attention_tflops_equals_jax(shape):
    b, h, sq, skv, d, causal = shape
    for seconds in (1e-3, 0.37):
        assert profiling.attention_tflops(seconds, b, h, sq, skv, d, causal) == \
            jprof.attention_tflops(seconds, b, h, sq, skv, d, causal)


def test_do_bench_on_cpu():
    x = torch.randn(64, 64)
    s = profiling.do_bench(lambda: x @ x, iters=3, warmup=1, reps=3, device="cpu")
    assert isinstance(s, float) and s > 0


@pytest.mark.parametrize("copies", [1, 3])
def test_chain_bench_on_cpu(copies):
    calls = []
    args = [(torch.randn(32, 32),) for _ in range(copies)]

    def fn(x):
        calls.append(x)
        return x @ x

    s = profiling.chain_bench(fn, args if copies > 1 else args[0], iters=6, reps=2, device="cpu")
    assert isinstance(s, float) and s > 0
    assert len(calls) == 1 + 2 * 6  # a warm-up call, then reps x iters
    assert {id(x) for x in calls[1:]} == {id(a[0]) for a in args}  # every copy in turn


def test_trace_writes_its_directory(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        torch.randn(16, 16).sum()
    assert os.path.isfile(log_dir / "trace.json")
    assert len(prof.key_averages()) > 0
