"""Nothing the benchmark runs on the chip, nor its reference, loads JAX
or the JAX package (top-level module names compared whole), the
reference loads nothing of the program, and a run without a card
prints no result and fails."""
import ast
import json
import os
import subprocess
import sys

from portbench.tests import threads  # noqa: F401
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_sources_import_nothing_of_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "torch", "portbench"}, path


def _python(code, *args):
    return subprocess.run(
        [sys.executable, "-c", code, *args], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{harness.ROOT}{os.pathsep}"
             f"{harness.ROOT / 'src'}"})


def test_a_run_loads_nothing_of_jax(tmp_path):
    """A whole tiny run on the CPU, then the loaded modules."""
    code = """
import json, os, sys, time
from portbench import harness
from portbench.tests import tiny
c = tiny.cell(tiny.config("mixtral-8x7b-l1"), tiny.mix())
out = harness.run_cell(c, 3, 0.2, True, "cpu", time.time(),
                       "file://" + os.path.join(sys.argv[1], "rdv"))
import portbench.calibrate, portbench.faults
print(json.dumps({"found": harness.forbidden_modules(),
                  "counted": out["forbidden_modules"],
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""
    r = _python(code, str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["found"] == [] and got["counted"] == 0
    assert not set(got["tops"]) & FORBIDDEN
    assert "repro_torch" in got["tops"]


def test_run_without_a_card_fails_without_a_result():
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral-8x7b-l1.train.2x4096", "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=300, env={**os.environ,
                                            "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA" in r.stderr
