"""The benchmark's own tests: `python -m pytest -q perfbench/tests` from
the repository root (the card's tests, marked `gpu`, skip without one)."""
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
