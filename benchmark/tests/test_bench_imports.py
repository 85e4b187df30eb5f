"""The benchmark loads nothing of JAX or the JAX package, and its plain
reference nothing of the program, compared by whole top-level module
names (``robogame_tpu_torch`` is the program, ``robogame_tpu`` the JAX
package)."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "robogame_tpu"}
FILES = sorted(p for p in harness.HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch", "types"}


def test_a_run_leaves_no_jax_module_loaded():
    """A small cell driven end to end in a fresh process, then its loaded
    modules' top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import _small\n"
        "from benchmark import harness\n"
        "code, _ = _small.run(_small.SWEEP, seconds=0.1)\n"
        "print(json.dumps({'code': code, 'bad': harness.forbidden_modules()"
        "}))\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", "import json\n" + code],
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"code": 0, "bad": []}


def _strings(path):
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) \
                and node.body and isinstance(node.body[0], ast.Expr):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_reads_the_jax_era_records():
    names = ("bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE.")
    for path in FILES:
        if path.parent.name == "tests":
            continue
        assert not any(n in s for s in _strings(path) for n in names), path
