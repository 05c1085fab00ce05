"""What runs on the card loads no JAX: a run's whole import path, driven
in a fresh process, leaves no module whose top-level name is jax, jaxlib,
flax or the JAX package, compared whole (the port's name begins with the
JAX package's); and nothing of the harness reads the JAX package's
benchmark folder."""
import ast
import os
import subprocess
import sys

from perfbench import spec

_DRIVE = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import run
from perfbench.tests import smoke
for w in ("mixtral-8x22b.serve-chat", "mixtral-8x22b.serve-longdoc"):
    run.execute(smoke.cell(w), 5, 0.0, False, device="cpu",
                t_start=time.perf_counter())
import perfbench.trace, perfbench.reference.fp8
print(",".join(run.barred_modules()) or "none")
print("repro_torch" in sys.modules)
"""


def test_run_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-c", _DRIVE.format(root=str(spec.ROOT),
                                             src=str(spec.ROOT / "src"))],
        capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "none"
    assert lines[-1] == "True"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_no_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro", "repro_torch", "jax", "jaxlib", "flax"}, \
            path


def test_nothing_reads_the_jax_benchmark_folder():
    folder = "bench" + "marks"
    for path in spec.BENCH_DIR.rglob("*.py"):
        text = path.read_text()
        assert folder not in text, path
        tops = {m.split(".")[0] for m in _imports(path)}
        assert folder not in tops
