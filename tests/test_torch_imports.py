"""The port stands alone: no module under ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the ``repro`` package
(an AST scan, so a lazy import inside a function counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.core import pq\n"
                     "import jax.numpy as jnp\nfrom . import sibling\n")
    assert sorted(m for m in _imported_modules(probe) if _forbidden(m)) == [
        "jax.numpy", "repro.core"]


def test_package_imports_without_building():
    """Importing every module compiles and loads nothing (checked in a
    fresh interpreter, so modules already imported here do not hide it)."""
    import subprocess
    import sys
    mods = []
    for path in FILES[:-1]:
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    code = ("import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "src",
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
