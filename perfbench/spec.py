"""A cell as the harness runs it: ``perfbench/workloads/<cell>.json`` and the
configuration it names, ``perfbench/configs/<config>.json``, found by name.

A configuration file holds the model's published ``config.json`` keys
(``config``), the program's preset that runs it (``preset``) with any
``overrides`` of the preset's other fields, ``reduced`` (keys changed from
the source), ``assumed`` (sizes or settings the source does not give), the
``deployment`` it stands for, and its ``family`` where that is not the
default: the module that reads its keys, draws its weights and holds its
reference (``perfbench/families/``).
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

from perfbench import families

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(name: str) -> Dict:
    """The cell file with its configuration file under ``"model"``."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["model"] = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    return cell


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def family(model: Dict) -> ModuleType:
    """The configuration's family module, ``perfbench/families/<family>.py``."""
    return importlib.import_module(f"{families.__name__}.{model.get('family', families.DEFAULT)}")


def program_config(model: Dict):
    """The program's config for a configuration file, checked against its
    published keys by its family."""
    return family(model).program_config(model)
