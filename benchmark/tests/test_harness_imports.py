"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "styletts2_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "styletts2_tpu_torch" not in tops, path
        assert tops <= {"__future__", "itertools", "math", "typing", "numpy", "torch",
                        "benchmark"}, (path, tops)
        assert all(n.startswith("benchmark.reference") for n in _imports(path)
                   if n.split(".")[0] == "benchmark"), path


def test_a_run_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.control, benchmark.check, "
            "styletts2_tpu_torch.serve, styletts2_tpu_torch.inference; "
            "from benchmark import spec; spec.entry(spec.ROOT / 'benchmark', 'synthesis'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_the_program_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ljspeech.single",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
