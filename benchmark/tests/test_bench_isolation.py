"""What the benchmark may import: nothing of JAX or of the JAX package anywhere under
``benchmark/``, and nothing of the program in the reference (top-level module names,
compared whole: ``pantomatrix_tpu_torch`` begins with ``pantomatrix_tpu``)."""
import ast
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "pantomatrix_tpu"}
PROGRAM = "pantomatrix_tpu_torch"


def imported_tops(path):
    """Top-level names of every module a file imports (relative imports excluded)."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))
REFERENCE = sorted((BENCH_DIR / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not imported_tops(path) & JAX_NAMES


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert PROGRAM not in tops
    # the reference stands alone: only torch, the standard library and itself
    assert tops <= {"torch", "math", "contextlib", "typing", "__future__"}, tops


def test_names_compare_whole():
    assert "pantomatrix_tpu_torch".split(".", 1)[0] not in JAX_NAMES


def test_loaded_modules_after_a_run():
    """A whole CPU run of a cell, in a fresh process, leaves no JAX module loaded, and
    the reference alone loads nothing of the program."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}, {str(BENCH_DIR)!r}, {str(ROOT)!r}]
import reference.camn, reference.emage
assert not any(m.split('.')[0] == {PROGRAM!r} for m in sys.modules), 'reference loads the program'
import time, run
from conftest import tiny_cell
from harness.common import forbidden_modules
run.run_cell(tiny_cell('camn-offline-bf16'), 7, 0.0, False, time.time(), device='cpu')
assert {PROGRAM!r} in sys.modules
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
