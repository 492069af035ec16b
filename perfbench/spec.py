"""A cell as the harness runs it: ``perfbench/workloads/<cell>.json`` and the
configuration it names, ``perfbench/configs/<config>.json``, found by name.

A configuration file holds the model's published ``config.json`` keys
(``config``), the program's preset that runs it (``preset``: a function of
``models/llama``) with any ``overrides`` of the preset's other fields,
``reduced`` (keys changed from the source), ``assumed`` (sizes or settings
the source does not give) and the ``deployment`` it stands for.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: LlamaConfig field <- published config.json key.
HF_FIELDS = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_layers": "num_hidden_layers",
    "num_q_heads": "num_attention_heads",
    "num_kv_heads": "num_key_value_heads",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_norm_eps",
    "window": "sliding_window",
    "num_experts": "num_local_experts",
    "num_experts_per_tok": "num_experts_per_tok",
}


def load_cell(name: str) -> Dict:
    """The cell file with its configuration file under ``"model"``."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["model"] = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    return cell


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def llama_config(model: Dict):
    """The program's ``LlamaConfig`` for a configuration file, checked
    against its published keys: a preset that disagrees with the file
    raises, so the file is the configuration as run."""
    from quantumattention_tpu_torch.models import llama

    cfg = getattr(llama, model["preset"])(**model.get("overrides", {}))
    hf = model["config"]
    for field, key in HF_FIELDS.items():
        want = hf.get(key, 0 if key == "num_local_experts" else None)
        if field == "num_experts_per_tok" and not hf.get("num_local_experts"):
            continue
        got = getattr(cfg, field)
        if (got != want) if not isinstance(got, float) else abs(got - float(want)) > 1e-12:
            raise ValueError(f"{model['preset']}: {field} = {got}, the configuration says {key} = {want}")
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    if cfg.head_dim != head_dim or cfg.tie_embeddings != bool(hf.get("tie_word_embeddings", False)):
        raise ValueError(f"{model['preset']}: head_dim or tied embeddings differ from the configuration")
    return cfg
