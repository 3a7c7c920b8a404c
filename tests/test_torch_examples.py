"""Each `examples/torch_*.py` runs with --device cpu at its smallest size,
in a fresh interpreter, and prints what its reference counterpart
prints; `torch_adaptive_layout.py`, given the reference example's
baseline terms, chooses the same layout as `examples/adaptive_layout.py`
(the predictor is pure arithmetic) and prints the same walk. No example
imports jax or the JAX package in its run, lazy imports included.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the baseline terms examples/adaptive_layout.py starts from
REF_TERMS = ("1.388", "11.308", "8.708")


# runs an example as __main__ with its arguments, then checks that
# nothing of jax or the JAX package was imported on the way
RUN_CHECKED = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


def run(script, *args, timeout=600, checked=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    path = str(ROOT / "examples" / script)
    cmd = ([sys.executable, "-c", RUN_CHECKED, path, *args] if checked
           else [sys.executable, path, *args])
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout + r.stderr


def test_quickstart():
    out = run("torch_quickstart.py", "--device", "cpu")
    assert "quickstart OK on cpu" in out and "greedy continuation" in out


def test_serve_lm():
    out = run("torch_serve_lm.py", "--device", "cpu", "--prompt-len", "8",
              "--gen-tokens", "4")
    assert "generated:" in out and "on cpu" in out


def test_train_lm(tmp_path):
    out = run("torch_train_lm.py", "--device", "cpu", "--steps", "2",
              "--seq-len", "16", "--ckpt-dir", str(tmp_path))
    assert "over 2 steps" in out


def test_train_aqora(tmp_path):
    out = run("torch_train_aqora.py", "--device", "cpu", "--episodes", "2",
              "--scale", "0.05", "--batch-size", "2", "--ckpt-dir",
              str(tmp_path))
    assert "AQORA" in out and "checkpointed agent" in out


def test_adaptive_layout_chooses_the_reference_layout():
    mine = run("torch_adaptive_layout.py", "--device", "cpu", "--terms",
               *REF_TERMS)
    theirs = run("adaptive_layout.py", checked=False)
    walk = [l for l in mine.splitlines() if not l.startswith("baseline")]
    assert walk == [l for l in theirs.splitlines()
                    if not l.startswith("baseline")]
    assert any(l.startswith("chosen layout: ") for l in walk)


def test_without_a_card_the_examples_ask_for_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "examples" / "torch_quickstart.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "device='cpu'" in r.stderr
