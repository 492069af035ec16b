"""What the harness loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``quantumattention_tpu`` (the JAX package; the
port's name begins with it, so names are compared whole), and a reference
that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "quantumattention_tpu_torch" not in _imports(path), path
    # What the reference's side draws its weights with is program-free too.
    assert "quantumattention_tpu_torch" not in _imports(HERE / "weights.py")


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run in a fresh interpreter, then its sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import run\n"
        "from perfbench.tests import tiny\n"
        "cell = tiny.cell()\n"
        "with tiny.kernels_forced():\n"
        "    res = run.execute(cell['name'], 3, 0.2, True, 0.0, device='cpu', bench=tiny.BENCH, cell=cell)\n"
        "assert res['correct'], res\n"
        "print(','.join(run.forbidden_modules()) or 'none')\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"
    assert "quantumattention_tpu_torch" in subprocess.run(
        [sys.executable, "-c", code.replace("print(','.join(run.forbidden_modules()) or 'none')",
                                            "print(sorted(m for m in sys.modules if m.startswith('quantumattention')))")],
        capture_output=True, text=True, timeout=300).stdout


def test_forbidden_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("quantumattention_tpu", None)
        sys.modules["quantumattention_tpu_torch_fake"] = object()
        assert "quantumattention_tpu" not in run.forbidden_modules()
        sys.modules["quantumattention_tpu.ops"] = object()
        assert "quantumattention_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
