"""The wave generator: the same seed gives the same waves; seeds and waves
differ in content, not in the amount of work; every cell file's traffic
fits its engine."""

import json
from pathlib import Path

import pytest

from perfbench.traffic import load

PARAMS = {"kind": "waves", "requests_per_wave": 64, "prompt": 1000, "new_tokens": 1000}
WORKLOADS = sorted((Path(__file__).resolve().parents[1] / "workloads").glob("*.json"))


def test_same_seed_same_waves():
    a, b = load(PARAMS, 32000, 2**31 + 17), load(PARAMS, 32000, 2**31 + 17)
    for i in (-1, 0, 1, 5):
        assert a.wave(i) == b.wave(i)


def test_seeds_and_waves_share_the_work():
    waves = [load(PARAMS, 32000, s).wave(i) for s in (1, 2, 3 * 2**31) for i in (-1, 0, 1)]
    assert all(len(w) == 64 and all(len(p) == 1000 and n == 1000 for p, n in w) for w in waves)
    assert len({tuple(p[0] for p, _ in w) for w in waves}) == len(waves)


def test_token_ids_in_vocabulary():
    w = load(PARAMS, 1000, 5).wave(0)
    assert all(0 <= t < 1000 for p, _ in w for t in p)


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_cell_traffic_fits_its_engine(path):
    cell = json.loads(path.read_text())
    eng = cell["engine"]
    wave = load(cell["traffic"], 32000, 3).wave(0)
    # A wave may queue past the slots (a backlog), but in whole rounds of them.
    assert len(wave) == cell["traffic"]["requests_per_wave"]
    assert len(wave) <= eng["num_slots"] or len(wave) % eng["num_slots"] == 0
    assert max(len(p) + n for p, n in wave) <= eng["max_len"]
    assert cell["check"]["min_compared_tokens"] <= cell["check"]["sample_requests"] * cell["traffic"]["new_tokens"]


def test_warm_up_wave_keeps_prompts_and_one_full_burst():
    from perfbench.drivers.serve import warm_up_wave

    wave = load(PARAMS, 32000, 9).wave(-1)
    warm = warm_up_wave(wave, 64)
    assert [p for p, _ in warm] == [p for p, _ in wave]
    # the first token comes from prefill, at most one eager step follows each
    # of the 64 prefill forwards, and a full burst of 64 steps is left
    assert all(n - 1 - 64 >= 64 for _, n in warm) and all(n < 1000 for _, n in warm)
    assert warm_up_wave([([1, 2], 5)], 64) == [([1, 2], 5)]


def test_warm_up_wave_of_a_backlog_is_its_first_slots():
    from perfbench.drivers.serve import warm_up_wave

    wave = load({**PARAMS, "requests_per_wave": 256}, 32000, 9).wave(-1)
    assert warm_up_wave(wave, 64, 64) == warm_up_wave(wave[:64], 64)
    assert warm_up_wave(wave[:64], 64, 64) == warm_up_wave(wave[:64], 64)
