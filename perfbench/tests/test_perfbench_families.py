"""Configuration families (``perfbench/families/``): the ``llama`` family
draws and computes what the harness drew and computed before families
existed; a family written as new files only (``families/modern.py``, whose
published keys name experts ``num_experts`` and RoPE's theta under
``rope_parameters``) is found by name and runs a whole cell, the driver and
the control taking their weights and reference from it; and the harness's
own files name no family."""

import ast
import copy
import hashlib
import json
import re
from pathlib import Path

import pytest
import torch

from perfbench import control, families, run, spec
from perfbench.families import llama
from perfbench.tests import modern_reference, tiny

HERE = Path(__file__).resolve().parent
PERFBENCH = HERE.parent
SEED = 2**31 + 11

#: Recorded from the harness before families existed (``weights.int8_tree``
#: and ``reference.llama.logits_at`` over the same tiny models and inputs).
TREE_SHA256 = {
    False: "9c91d2152e941c4905f61c836699f2b605bdeff3b9f20d822995905efec4be94",
    True: "9290d99fff276c9e4551eda589244ad732b487804b8e3fef4bf9d13f448d1a8e",
}
LOGITS_SHA256 = {
    (False, "ref"): "f8eff1c09a19b43c28a7710ae6c37462191a3a55369c04125e134a98721b4763",
    (False, "int4"): "8096cea866092aefb20e9a3213469061c58905d7c08acd2a882b70463ddc8280",
    (True, "ref"): "3dd4e092e04eb2c4cadc46ec7e1a52807111b5c72e9532e2c91aabb19bda8a31",
    (True, "int4"): "eeb34b9080e58c6708f67fba5c96b201f84bfabb7c561a88dfd5ff11120e1833",
}

#: The files of the harness that go through a configuration's family.
HARNESS = ("spec.py", "run.py", "drivers/serve.py", "control.py", "program_spans.py", "weights.py")
FAMILY_WORDS = re.compile(r"llama|mistral|mixtral", re.IGNORECASE)
LEAVES = re.compile(r"\b(attn_norm|mlp_norm|wq|wk|wv|wo|w_qkv|w_gate|w_up|w_down|w_router|moe|embed|"
                    r"final_norm|lm_head)\b")


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{pre}{i}.")
    else:
        yield pre[:-1], tree


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _tree_digest(tree):
    h = hashlib.sha256()
    for name, t in _leaves(tree):
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}:".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("moe", [False, True])
def test_llama_draws_and_reference_unchanged(moe):
    model = tiny.model(moe)
    fam = spec.family(model)
    assert fam is llama and "family" not in model
    assert _tree_digest(fam.int8_tree(spec.program_config(model), SEED, "cpu")) == TREE_SHA256[moe]
    sizes = fam.sizes(model)
    ref = fam.reference
    seqs = [[(7 * i + 3) % 512 for i in range(70)], [(11 * i + 5) % 512 for i in range(45)]]
    logits = ref.logits_at(ref.shape_of(model["config"]), seqs, [range(60, 70), range(45)],
                           fam.int8_top(sizes, SEED, "cpu"), lambda i: fam.int8_layer(sizes, i, SEED, "cpu"),
                           variants={"ref": lambda w: w, "int4": ref.int4_roundtrip})
    for name, per_seq in logits.items():
        assert _digest(per_seq) == LOGITS_SHA256[moe, name], name


#: What the harness takes from a family (``perfbench/families/__init__.py``).
FAMILY_API = ("program_config", "sizes", "int8_top", "int8_layer", "int8_tree", "reference")
REFERENCE_API = ("shape_of", "logits_at", "served_gaps", "chosen_gaps", "int4_roundtrip")


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_configuration_files_keep_the_default_family(name):
    model = json.loads((PERFBENCH / "configs" / f"{name}.json").read_text())
    assert "family" not in model and spec.family(model) is llama
    assert spec.family({}) is llama and families.DEFAULT == "llama"


@pytest.mark.parametrize("path", sorted((PERFBENCH / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_configuration_finds_its_family(path):
    """A configuration naming a new family passes once that family's
    module is there: nothing here lists the families."""
    fam = spec.family(json.loads(path.read_text()))
    assert all(callable(getattr(fam, f)) for f in FAMILY_API[:-1])
    assert all(callable(getattr(fam.reference, f)) for f in REFERENCE_API)


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("name", HARNESS)
def test_harness_files_name_no_family(name):
    path = PERFBENCH / name
    assert not any(m.startswith("perfbench.reference") for m in _imports(path)), path
    text = path.read_text()
    assert not FAMILY_WORDS.search(text), FAMILY_WORDS.search(text).group(0)
    assert not LEAVES.search(text), LEAVES.search(text).group(0)


def _program_imports(node):
    names = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            names.update(a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            names.add(n.module or "")
    return {m for m in names if m.split(".")[0] == "quantumattention_tpu_torch"}


def test_families_import_the_program_only_to_build_its_config():
    """A family's weights and reference take nothing of the program: its
    only import of the program is the preset behind its config builder."""
    for path in (PERFBENCH / "families").glob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if not (isinstance(node, ast.FunctionDef) and node.name == "preset"):
                assert not _program_imports(node), (path, getattr(node, "name", None))


# ---------------------------------------------------------------------------
# The fixture family, found by name
# ---------------------------------------------------------------------------


def modern_model(moe: bool):
    """The tiny model (the program's ``tiny`` preset) with its keys written
    the newer way."""
    m = tiny.model(moe)
    hf = m["config"]
    hf["rope_parameters"] = {"rope_theta": hf.pop("rope_theta"), "rope_type": "default"}
    if moe:
        hf["num_experts"] = hf.pop("num_local_experts")
    m.update(name="tiny-modern", family="modern")
    return m


def modern_cell(moe: bool):
    c = tiny.cell(moe)
    c["model"] = modern_model(moe)
    return c


@pytest.fixture
def modern(monkeypatch):
    """The fixture family's directory on the families' search path, and its
    call counts cleared."""
    monkeypatch.setattr(families, "__path__", [*families.__path__, str(HERE / "families")])
    modern_reference.CALLS.clear()
    return modern_reference.CALLS


@pytest.mark.parametrize("moe", [False, True])
def test_the_llama_family_refuses_the_newer_keys(moe):
    with pytest.raises((ValueError, TypeError)):
        llama.program_config({**modern_model(moe), "family": "llama"})


@pytest.mark.parametrize("moe", [False, True])
def test_a_family_checks_its_own_keys(modern, moe):
    model = modern_model(moe)
    fam = spec.family(model)
    assert fam.__name__ == "perfbench.families.modern"
    cfg = spec.program_config(model)
    assert cfg.num_experts == (4 if moe else 0) and cfg.rope_theta == 10000.0
    wrong = copy.deepcopy(model)
    wrong["config"]["rope_parameters"]["rope_theta"] = 500000.0
    with pytest.raises(ValueError, match="rope_theta"):
        spec.program_config(wrong)


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_fixture_family_rehearsal(modern, moe, traced):
    cell = modern_cell(moe)
    with tiny.kernels_forced():
        res = run.execute(cell["name"], 2**31 + 123, 0.3, traced, 0.0, device="cpu", bench=tiny.BENCH, cell=cell)
    assert res["correct"] is True and res["failed"] == 0
    if traced:
        assert "burst_step_pct" in res["metrics"]
        assert set(res["metrics"]) <= {m["name"] for m in tiny.BENCH["per_layer"] if cell["name"] in m["workloads"]}
    else:
        assert set(res["metrics"]) == {"output_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}
    # The program's config, the engine's tree and the reference's layers
    # came from the fixture.
    layers = cell["model"]["config"]["num_hidden_layers"]
    assert modern["program_config"] == modern["int8_tree"] == modern["sizes"] == modern["logits_at"] == 1
    assert modern["int8_layer"] == layers and modern["shape_of"] >= 1


@pytest.mark.parametrize("moe", [False, True])
def test_fixture_family_control(modern, moe):
    with tiny.kernels_forced():
        out = control.readings("tiny", 21, device="cpu", cell=modern_cell(moe))
    key = out["compare"]
    assert out["control"][key] > 3 * max(out["program"][key], 1e-3) and out["control"][key] > out["limit"]
    assert modern["int8_tree"] == 1 and modern["logits_at"] == 1
