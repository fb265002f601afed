"""No JAX in a run: the check compares whole top-level names, and the
harness with the program loaded holds none of them; the plain reference
imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


@pytest.mark.parametrize("module,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("deeplabv3plus_keras_tpu", True), ("deeplabv3plus_keras_tpu.api", True),
    ("deeplabv3plus_keras_tpu_torch", False), ("deeplabv3plus_keras_tpu_torch.api", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_whole_top_level_names(monkeypatch, module, flagged):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, module, object())
    assert bool(run.forbidden_modules()) == flagged


def _run(code: str) -> str:
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True)
    return done.stdout.strip()


def test_a_run_loads_no_jax():
    """Everything a run imports, the program with it, loads no forbidden
    module."""
    out = _run("import benchmark.run as r, benchmark.loops, benchmark.control, "
               "benchmark.counts, benchmark.trace, benchmark.cells; "
               "r._ = benchmark.loops.port(); print(r.forbidden_modules())")
    assert out == "[]"


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("deeplabv3plus_keras_tpu_torch", *run.FORBIDDEN), (f, n)
    out = _run("import sys, benchmark.reference.model, benchmark.reference.prep, "
               "benchmark.reference.train; "
               "print(sorted({m.split('.')[0] for m in sys.modules} & "
               "{'deeplabv3plus_keras_tpu_torch', 'jax', 'flax', 'deeplabv3plus_keras_tpu'}))")
    assert out == "[]"
