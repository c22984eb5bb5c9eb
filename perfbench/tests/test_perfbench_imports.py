"""Nothing the benchmark imports is JAX or the JAX package (top-level names
compared whole: the port's name begins with the package's), the reference
imports nothing of the program, and nothing reads the JAX package's
benchmarks."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchlib import spec

BENCH = spec.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "whisperx_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"whisperx_tpu_torch", "benchlib"}


def test_nothing_reads_the_jax_benchmarks():
    me = Path(__file__).resolve()
    for path in SOURCES:
        if path.resolve() == me:
            continue
        text = path.read_text()
        assert "bench.py" not in text and "chip_smoke" not in text and "benchmarks/" not in text, path


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; torch.set_num_threads(2)\n"
        "import tiny, control; from benchlib import runner\n"
        "runner.run(tiny.cell(), 3, 1.0, True, 'cpu', log=lambda m: None)\n"
        "control.readings(tiny.cell(), 4, 1.0, 'cpu', lambda m: None)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH / "tests")], cwd=str(spec.ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "whisperx_tpu_torch" in loaded and not loaded & FORBIDDEN
