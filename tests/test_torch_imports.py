"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor anything of ``repro``, builds no kernel and needs no
card; ``chip_smoke.py`` imports the port only."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_WALK = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
from repro_torch.kernels import build
assert not build._LIBS, "a kernel library was loaded at import time"
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", _WALK], cwd=ROOT / "src", check=True,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")})
    n_files = len([p for p in PKG.rglob("*.py")])
    assert int(out.stdout.strip()) == n_files


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_names_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}, path


def test_expected_layout():
    for sub in ("core", "kernels", "nn", "models", "serve", "configs",
                "launch"):
        assert (PKG / sub / "__init__.py").is_file(), sub
    assert (PKG / "bridge.py").is_file()


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # on a machine with a card the script is its own test
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs an NVIDIA card" in out.stderr
