"""The port stands alone: no module of zignal_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package (zignal_tpu),
not even its JAX-free modules. Checked on the source (every import
statement) and at run time in a fresh interpreter (tests/conftest.py
imports jax into this process)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "zignal_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zignal_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(n for n in _imports(tree) if _forbidden(n))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_forbidden_names_are_caught():
    tree = ast.parse("import jax.numpy\nfrom zignal_tpu.codecs import png\n"
                     "from zignal_tpu_torch import Image\nimport numpy\n"
                     "__import__('zignal_tpu')\n")
    assert sorted(n for n in _imports(tree) if _forbidden(n)) == \
        ["jax.numpy", "zignal_tpu", "zignal_tpu.codecs"]


def test_importing_every_module_pulls_in_neither():
    code = (
        "import importlib, pkgutil, sys\n"
        "import zignal_tpu_torch\n"
        "for m in pkgutil.walk_packages(zignal_tpu_torch.__path__,\n"
        "                               'zignal_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'zignal_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('zignal_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(SOURCES) - 1
