"""The port stands alone: importing every `repro_torch` module loads no
JAX and nothing of the JAX package `repro`, and `chip_smoke.py` imports
neither.  Checked in a fresh subprocess so this test process's own JAX
imports cannot hide a leak."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(len(names))
print(" ".join(leaked))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = (out.stdout.splitlines() + [""])[:2]
    import repro_torch
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert int(n_modules) == expected >= 15
    assert leaked == "", f"port imported {leaked}"


def test_chip_smoke_imports_only_the_port_torch_and_numpy():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "jax" not in roots and "jaxlib" not in roots
    assert "repro" not in roots
    assert "repro_torch" in roots
