"""What the benchmark loads: nothing it runs imports JAX, flax or the JAX
package `repro` (top-level names compared whole: the port's `repro_torch`
begins with `repro`), the plain reference imports nothing of the program,
and a run without the program or without CUDA prints no result."""
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
SRC = ROOT / "src"


def _loaded(code):
    """Top-level names of the modules loaded after running `code` in a
    fresh interpreter."""
    prog = (f"import sys; sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
            f"{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_names():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    assert "repro" in run.FORBIDDEN and "repro_torch" not in run.FORBIDDEN


def test_nothing_the_benchmark_runs_imports_jax():
    """Every module of the benchmark and the program modules a run
    imports, and a whole run's path at tiny widths on the CPU."""
    code = "\n".join([
        "import pathlib, importlib",
        "from perfbench import run, control",
        "from perfbench.harness import cell, compare, faults, trace, weights",
        "from perfbench.reference import lm, train",
        "from perfbench.work import flops, kernels",
        f"for f in sorted(pathlib.Path({str(BENCH)!r}).glob('*/*.py')):",
        "    if f.parent.name in ('metrics', 'generators'):",
        "        cell.load_module(f)",
        "import time",
        "from perfbench.tests import tiny",
        "cell.run(tiny.spec('moe'), 5, 0.2, True, time.time(),",
        "         cell.Rank(device='cpu'))",
    ])
    loaded = _loaded(code)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded("from perfbench.reference import lm, train")
    assert "repro_torch" not in loaded and "repro" not in loaded
    for f in (BENCH / "reference").glob("*.py"):
        text = f.read_text()
        assert "repro_torch" not in text.replace(
            "Imports nothing of the program", "")


def _run(cwd, args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "qwen1.5-4b.train.2x4096", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def test_without_a_card_no_result(card):
    if card:
        pytest.skip("a card is here: a run would measure")
    got = _run(ROOT, ARGS)
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path, ARGS)
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    return torch.cuda.is_available()
