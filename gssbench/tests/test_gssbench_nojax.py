"""No JAX in a run: the check of ``sys.modules`` by whole top-level
names, and no import of ``jax`` or ``repro`` anywhere in the benchmark;
the reference imports nothing of ``repro_torch``."""
import ast
from pathlib import Path

import pytest

from gssbench import harness

HERE = Path(harness.__file__).resolve().parent


def test_top_level_names_compared_whole():
    mods = ["repro_torch", "repro_torch.solver", "numpy", "jaxtyping",
            "reproducible", "torch._jax_like"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "repro.core",
                                             "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro.core"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_benchmark(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "build_reference.py",
                                  "roofline.py", "graphs/mesh2d.py",
                                  "graphs/grid2d.py"])
def test_the_yardstick_takes_nothing_from_the_program(name):
    tops = {m.split(".")[0] for m in _imports(HERE / name)}
    assert "repro_torch" not in tops and not tops & set(harness.FORBIDDEN)


def test_a_run_leaves_no_jax_loaded():
    """A whole run at a tiny size in a fresh process, as ``run.py`` runs
    it, then the check ``run.py`` makes."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gssbench import harness\n"
        "from gssbench.manifest import Manifest\n"
        "from gssbench.tests.conftest import tiny\n"
        "m = Manifest.load()\n"
        "cfg, tr = tiny(m, 'mesh2d-1024.solve-b32', 12)\n"
        "r = harness.run_cell(m, 'mesh2d-1024.solve-b32', 5, 0.2, True,\n"
        "                     device='cpu', config=cfg, traffic=tr)\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    """No CUDA device, or a directory holding only the benchmark: a
    nonzero exit and nothing on standard output."""
    import shutil
    import subprocess
    import sys

    args = ["--workload", "mesh2d-1024.solve-b32", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "gssbench/run.py", *args],
                         cwd=HERE.parent, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gssbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gssbench/run.py", *args],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
