"""The port imports torch and never jax, and imports without a GPU toolchain."""

import ast
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "quantumattention_tpu_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "quantumattention_tpu"), f"{path}: {mod}"


def test_port_imports_without_jax_or_toolchain():
    """Every module imports in a fresh interpreter where jax cannot load,
    and nothing is built at import time."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['triton'] = None\n"
        "import importlib, pkgutil, quantumattention_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from quantumattention_tpu_torch.ops import _native\n"
        "assert _native._State.lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=PKG.parent, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
