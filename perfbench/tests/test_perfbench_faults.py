"""The check fails a broken timed path.  A serving run on the CPU (tiny
size, the harness's look for a card skipped) with a fault planted under
the engine must come out not correct: a token altered where it is sampled
(every sampling path: prefill, eager steps, bursts), and a decode step
that leaves the cache as it found it."""

import pytest

from perfbench import run
from perfbench.tests import tiny


def _run(moe=False, queue=False):
    cell = tiny.cell(moe, queue=queue)
    with tiny.kernels_forced():
        return run.execute(cell["name"], 4242, 0.3, False, 0.0, device="cpu", bench=tiny.BENCH, cell=cell)


@pytest.mark.parametrize("moe", [False, True])
def test_sound_run_is_correct(moe):
    assert _run(moe)["correct"] is True


@pytest.mark.parametrize("moe", [False, True])
def test_altered_token_fails(monkeypatch, moe):
    from quantumattention_tpu_torch.serving import backends, engine

    def altered(sample):
        def fn(logits, *a, **k):
            tok = sample(logits, *a, **k)
            return (tok + 1) % logits.shape[-1]
        return fn

    monkeypatch.setattr(engine, "sample", altered(engine.sample))
    monkeypatch.setattr(backends, "sample", altered(backends.sample))
    res = _run(moe)
    assert res["correct"] is False
    key = "gap_mean" if moe else "gap_max"
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


@pytest.mark.parametrize("moe", [False, True])
def test_unchanged_state_fails(monkeypatch, moe):
    from quantumattention_tpu_torch.serving import backends

    monkeypatch.setattr(backends.kvc, "append_quantized_token", lambda cache, *a, **k: cache)
    monkeypatch.setattr(backends.kvc, "append", lambda cache, *a, **k: cache)
    res = _run(moe)
    assert res["correct"] is False


def test_backlog_faults_fail(monkeypatch):
    """The same faults in a wave four times the slots, whose steps while
    requests wait are single steps."""
    from quantumattention_tpu_torch.serving import backends, engine

    assert _run(queue=True)["correct"] is True
    with monkeypatch.context() as m:
        m.setattr(backends.kvc, "append_quantized_token", lambda cache, *a, **k: cache)
        m.setattr(backends.kvc, "append", lambda cache, *a, **k: cache)
        assert _run(queue=True)["correct"] is False
    for mod in (engine, backends):
        sample = mod.sample
        monkeypatch.setattr(mod, "sample", lambda logits, *a, _s=sample, **k: (_s(logits, *a, **k) + 1) % logits.shape[-1])
    res = _run(queue=True)
    assert res["correct"] is False and res["checks"]["gap_max"]["value"] > res["checks"]["gap_max"]["limit"]
