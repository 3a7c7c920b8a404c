"""Time the selective scan's backward kernel on the card, and where one
chunk's time goes. Run from the repository root on a machine with an
NVIDIA H100:

    python3 tools/scan_bwd_bench.py

It builds, under build/scan_bwd_bench/, src/repro_torch/kernels/csrc/
mamba_scan_bwd.cu as it is and a copy with clock64() reads around each
phase of a chunk (thread 0, which also adds the cluster's sums, and
thread 64 of block (0, 0)), then at falcon-mamba-7b's train shape (B 2, S
512, d_inner 8192, N 16, the cotangent of y) and at 1 x 2048 with h0 and
both cotangents, from the forward kernel's chunk states:
- the kernel's ms over 10 back-to-back launches by CUDA events, in turns
  with the clocked copy, four rounds;
- the clocked copy's mean cycles a chunk in each phase: "top" (the
  ring's wait and the block barrier, then the cluster's wait and its sums
  of the previous chunk), "recompute" (the chunk's states and decays),
  "walk" (the reverse walk), "barrier" (the block barrier after it),
  "sums" (dx/ddt written back, the block's dB/dC sums);
- whether the kernel's gradients equal the module's bit for bit.
Prints one JSON object a shape and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build, mamba_scan as ms  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu"
OUT = ROOT / "build" / "scan_bwd_bench"
PHASES = ("top", "recompute", "walk", "barrier", "sums")
# (anchor in the source, text put before it) for the clocked copy
CLOCKS = (
    ("namespace cg = cooperative_groups;\n",
     "__device__ unsigned long long g_clk[16];\n"),
    ("    cp_wait<kStages - 2>();                      // chunk c has landed\n",
     "    long long c0 = clock64();\n"),
    ("    float* const st = ring + (c % kStages) * Lay::kStage;\n",
     "    long long c1 = clock64();\n"),
    ("    // the walk back, L steps a group\n",
     "    long long c2 = clock64();\n"),
    ("    __syncthreads();                             // the chunk's dx, ddt, terms\n",
     "    long long c3 = clock64();\n"),
    ("    // dx and ddt back to device memory, coalesced\n",
     "    long long c4 = clock64();\n"),
    ("    cluster_arrive();\n  }\n",
     "    if (blockIdx.x == 0 && blockIdx.y == 0 && (tid == 0 || tid == 64)) {\n"
     "      unsigned long long* k = g_clk + (tid ? 8 : 0);\n"
     "      const long long c5 = clock64();\n"
     "      const long long d[5] = {c1 - c0, c2 - c1, c3 - c2, c4 - c3,\n"
     "                              c5 - c4};\n"
     "      for (int i = 0; i < 5; ++i)\n"
     "        atomicAdd(k + i, static_cast<unsigned long long>(d[i]));\n"
     "      atomicAdd(k + 5, 1ull);\n"
     "    }\n"),
    ('extern "C" int mamba_scan_bwd_parts(int di) {',
     'extern "C" int scan_bwd_clocks(unsigned long long* out, int reset) {\n'
     '  if (reset) {\n'
     '    unsigned long long z[16] = {0};\n'
     '    return cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n'
     '  }\n'
     '  return cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n'
     '}\n'),
)


def clocked(src: str) -> str:
    for anchor, text in CLOCKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    return src


def build_libs():
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    srcs = {"kernel": text, "clocked": clocked(text)}
    procs = {}
    for name, s in srcs.items():
        path = OUT / f"{name}.cu"
        path.write_text(s)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(OUT / f"lib{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fn = libs[name].mamba_scan_backward
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def shape_case(libs, B, S, di, N, full):
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    x, dt = rn(B, S, di), rn(B, S, di).abs() * 0.1
    A = -torch.arange(1, N + 1, device="cuda",
                      dtype=torch.float32).repeat(di, 1)
    Bs, Cs, D = rn(B, S, N), rn(B, S, N), rn(di)
    h0 = rn(B, di, N) if full else None
    gy, gh = rn(B, S, di), (rn(B, di, N) if full else None)
    states = ms._forward(x, dt, A, Bs, Cs, D, h0, with_states=True)[2]
    want = ms.mamba_scan_bwd(x, dt, A, Bs, Cs, D, h0, gy, gh, states)
    grads = [torch.empty_like(t) for t in (x, dt, A, Bs, Cs, D)]
    grads.append(None if h0 is None else torch.empty_like(h0))
    parts = libs["kernel"].mamba_scan_bwd_parts(di)
    part_bc = torch.empty((parts, 2, B, S, N), device="cuda")
    part_ad = torch.empty((B, di * (N + 1)), device="cuda")

    def ptr(t):
        return None if t is None else t.data_ptr()
    args = [ptr(t) for t in (x, dt, A, Bs, Cs, D, h0, gy, gh, states,
                             *grads, part_bc, part_ad)]
    args += [B, S, di, N, torch.cuda.current_stream().cuda_stream]
    ms_by = {n: [] for n in libs}
    for rnd in range(4):
        for n in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            fn = libs[n].mamba_scan_backward
            fn(*args)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                fn(*args)
            e1.record()
            torch.cuda.synchronize()
            ms_by[n].append(e0.elapsed_time(e1) / 10)
    libs["kernel"].mamba_scan_backward(*args)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(grads, want)
                if a is not None)
    buf = (ctypes.c_ulonglong * 16)()
    lib = libs["clocked"]
    lib.scan_bwd_clocks(buf, 1)
    lib.mamba_scan_backward(*args)
    torch.cuda.synchronize()
    lib.scan_bwd_clocks(buf, 0)
    clocks = {}
    for tid, o in ((0, 0), (64, 8)):
        n = max(buf[o + 5], 1)
        clocks[f"thread{tid}"] = {p: buf[o + i] / n
                                  for i, p in enumerate(PHASES)}
        clocks[f"thread{tid}"]["chunks"] = buf[o + 5]
    return {"shape": {"B": B, "S": S, "di": di, "N": N, "h0_gh": full},
            "ms": ms_by, "cycles_per_chunk": clocks,
            "bit_equal_to_module": equal}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    libs = build_libs()
    for case in ((2, 512, 8192, 16, False), (1, 2048, 8192, 16, True)):
        print(json.dumps(shape_case(libs, *case)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
