"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C entry point. On first use it is
compiled for Hopper into `build/kernels/lib<name>-<digest>.so` under the
repository root; the digest covers the source and the flags, so an edited
source builds anew and an unchanged one is reused. `build()` starts one
nvcc per missing source, all at once, and waits for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("tree_cnn_fused",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"path", "seconds", "cached", "ptxas"} for every build this process
# made or found
build_log: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return str(nvcc)


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source in `names` that has no library yet, one nvcc
    process per source, all started together. Raises on any failure."""
    running = []
    for name in names:
        so = library_path(name)
        if so.exists():
            build_log.setdefault(name, {"path": str(so), "seconds": 0.0,
                                        "cached": True, "ptxas": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running.append((name, so, tmp, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, t0, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}{err}")
            continue
        os.replace(tmp, so)
        build_log[name] = {"path": str(so), "cached": False,
                           "seconds": time.perf_counter() - t0,
                           "ptxas": (out + err).strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
