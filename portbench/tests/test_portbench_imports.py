"""Nothing the benchmark runs imports JAX or the JAX package: a module
counts by its whole top-level name, so ``repro_torch`` passes and
``repro`` does not; the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench.imports import forbidden_modules
from portbench.manifest import BENCH_DIR, ROOT


@pytest.mark.parametrize("name,bad", [
    ("repro", True), ("repro.core.pq", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("repro_torch", False), ("repro_torch.core", False), ("reprox", False),
    ("jaxtyping", False), ("portbench.reference", False)])
def test_whole_top_level_name(name, bad):
    assert forbidden_modules([name]) == ([name] if bad else [])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


FILES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert forbidden_modules(list(_imports(path))) == []


@pytest.mark.parametrize(
    "path", sorted((BENCH_DIR / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = list(_imports(path))
    assert not [n for n in names if n.split(".")[0] == "repro_torch"]
    # relative imports stay inside the reference package
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, f"{path.name} reaches out of reference/"


def test_a_run_loads_no_jax():
    """A tiny run on the CPU, in a fresh interpreter, then the modules."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench.harness import run_cell\n"
            "from portbench.tests.conftest import TINY\n"
            "import io\n"
            "run_cell('electric-classify', 3, 0.3, False, device='cpu',"
            " overrides=TINY, out=io.StringIO(), err=io.StringIO())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'}))\n"
            % (str(ROOT / "src"), str(ROOT)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
