"""The port stands alone and its copied modules do not drift.

* `repro_torch` and `chip_smoke.py` import neither jax nor any `repro`
  module (checked in a fresh interpreter);
* every numpy/pure-Python module the port copies from `repro` equals the
  reference source after `repro.` -> `repro_torch.`, apart from the short
  explicit allow-list below (the jax-free key in `core/rollout.py`) and
  comments that named project history;
* `AqoraAgent` without a device asks for CUDA and raises without it.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# module paths (relative to src/repro and src/repro_torch) copied verbatim
COPIES = (
    "gen/spec.py", "gen/seeds.py",
    "sql/query.py", "sql/catalog.py", "sql/datagen.py", "sql/workloads.py",
    "sql/plans.py", "sql/cluster.py", "sql/cbo.py",
    "serve/cache.py", "sql/executor.py",
    "core/encoding.py", "core/actions.py", "core/rollout.py",
    "core/vec_rollout.py",
    "serve/deltas.py", "serve/scheduler.py", "serve/service.py",
    "serve/driver.py",
    "learn/__init__.py", "learn/replay.py", "learn/harvest.py",
    "learn/curriculum.py", "learn/policy_store.py", "learn/learner.py",
    "serve/qos/__init__.py", "serve/qos/tenancy.py", "serve/qos/degrade.py",
    "serve/qos/admission.py",
    "serve/recover/__init__.py", "serve/recover/faults.py",
    "serve/recover/retry.py", "serve/recover/hedge.py",
    "serve/recover/breaker.py", "serve/recover/manager.py",
    "serve/obs/__init__.py", "serve/obs/metrics.py", "serve/obs/trace.py",
    "serve/obs/explain.py", "serve/obs/anomaly.py", "serve/obs/rca.py",
    "serve/obs/monitor.py", "serve/obs/export.py", "serve/obs/report.py",
    "serve/drift/__init__.py", "serve/drift/detector.py",
    "serve/drift/policy.py", "serve/drift/probes.py",
    "serve/drift/controller.py",
    "serve/plans/__init__.py", "serve/plans/memory.py",
    "serve/plans/superopt.py",
    "gen/__init__.py", "gen/schema.py", "gen/queries.py", "gen/streams.py",
    "gen/world.py", "serve/__init__.py",
    "baselines/__init__.py", "baselines/spark_default.py",
    "baselines/cbo_serve.py",
    "configs/registry.py", "configs/dbrx_132b.py",
    "configs/falcon_mamba_7b.py", "configs/gemma2_27b.py",
    "configs/jamba_15_large.py", "configs/llama32_vision_90b.py",
    "configs/llama4_scout_17b.py", "configs/minicpm3_4b.py",
    "configs/qwen15_4b.py", "configs/qwen3_8b.py", "configs/whisper_tiny.py",
    "data/__init__.py", "data/pipeline.py",
    "runtime/__init__.py", "runtime/elastic.py",
)

# Comments in the reference that name project history ("the PR-n path")
# are reworded in the copies; nothing else changes but these seams.
HISTORY = ((re.compile(r"PR-\d+(?:\.\.\d+)?(?:/PR-\d+)?"), "original"),
           (re.compile(r"seed PR\b"), "seed"),
           (re.compile(r" \(PR \d+(?:-\d+)?\)"), ""))

# (reference snippet, port snippet) per file, applied after the rename
ALLOWED = {
    "core/rollout.py": [
        ("import jax\nimport numpy as np\n", "import numpy as np\n"),
        ("from repro_torch.core.encoding import WorkloadMeta, encode_state\n",
         "from repro_torch.core.encoding import WorkloadMeta, encode_state\n"
         "from repro_torch.core.prng import prng_key\n"),
        ("        return np.asarray(jax.random.PRNGKey(int(key)), np.uint32)\n",
         "        return prng_key(int(key))\n")],
}


def port_source(rel: str, ref_src: str) -> str:
    """What the port's copy of `rel` must hold, given the reference source."""
    out = ref_src.replace("repro.", "repro_torch.")
    for pattern, repl in HISTORY:
        out = pattern.sub(repl, out)
    for old, new in ALLOWED.get(rel, ()):
        assert out.count(old) == 1, (rel, old)
        out = out.replace(old, new)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == port_source(rel, ref), \
        f"repro_torch/{rel} drifted from repro/{rel}"


def _fresh_python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


_LEAK_CHECK = """
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("clean", n)
"""


# the kernel modules, named so that the walk below cannot miss one
KERNEL_MODULES = ("build", "ref", "ops", "tree_conv", "mamba_scan",
                  "flash_attention")


def test_port_imports_neither_jax_nor_reference():
    r = _fresh_python(
        "import sys, importlib, pkgutil\n"
        "import repro_torch\n"
        "n = 0\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name); n += 1\n"
        f"kernels = {KERNEL_MODULES!r}\n"
        "missed = [k for k in kernels\n"
        "          if 'repro_torch.kernels.' + k not in sys.modules]\n"
        "assert not missed, missed\n"
        + _LEAK_CHECK)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= len(COPIES)


def test_chip_smoke_imports_neither_jax_nor_reference():
    r = _fresh_python(
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        + _LEAK_CHECK)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) > 0


def test_agent_without_device_needs_cuda(monkeypatch):
    from repro_torch.core.agent import AgentConfig, AqoraAgent
    from repro_torch.core.encoding import WorkloadMeta
    meta = WorkloadMeta({"a": 0, "b": 1}, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AqoraAgent(meta, AgentConfig(hidden=8, head_hidden=8))
    ag = AqoraAgent(meta, AgentConfig(hidden=8, head_hidden=8), device="cpu")
    assert ag.device.type == "cpu"
