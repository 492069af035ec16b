"""``BENCHMARK.json`` and the files it names: every cell, configuration
and per-layer metric has its file, the readers agree with their entries,
and each configuration's preset is the program's run of its published
keys."""

import json
import re
from pathlib import Path

import pytest

from perfbench import run, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = spec.load_cell(cell)
    assert c["config"] == entry["config"] and c["chips"] == entry["chips"] in (1, 4)
    assert c["why"] == entry["why"] and len(entry["why"]) <= 200
    e2e, layer = run.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_agrees_with_entry(metric):
    mod = run.reader(metric["name"])
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        metric["name"], metric["unit"], metric["layer"], metric["moves"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    model = json.loads((ROOT / config["file"]).read_text())
    assert model["name"] == config["name"] and model["source"] == config["source"]
    assert model["reduced"] == config["reduced"]
    if config["name"] in ("mistral-7b", "mixtral-8x7b"):
        assert config["reduced"] == []
    spec.program_config(model)  # raises where the preset departs from the published keys


def test_kernel_and_mfu_pairs():
    """Every cell with a kernel's roofline reports a whole step's mfu that
    moves the same end-to-end metric."""
    for w in BENCH["workloads"]:
        _, layer = run.cell_metrics(BENCH, w["name"])
        moved_by_mfu = {m["moves"] for m in layer if "mfu" in m["name"]}
        for m in layer:
            if m["name"].endswith("_roofline"):
                assert m["moves"] in moved_by_mfu, (w["name"], m["name"])
