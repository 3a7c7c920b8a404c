#!/usr/bin/env python3
"""Measure the fused TreeCNN backward kernel (csrc/tree_cnn_fused_bwd.cu)
on the card, apart from chip_smoke.py. Run from a checkout's root, on the
machine with the GPU:

    python3 tools/bwd_bench.py time [--parent-src FILE]
        the kernel at the PPO shapes (24 and 32 trees, N=48, F=26, H=96)
        by CUDA events, with its occupancy and the worst share of 1e-5 +
        1e-4 |plain| over the weight gradients; with --parent-src, also an
        earlier source of the same C interface, built beside it, timed in
        turns (kernel, parent, parent, kernel) and compared bit for bit
    python3 tools/bwd_bench.py variant NAME [KNOB=VALUE ...] [--clocks]
        copy the checkout to build/NAME with the kernel's #define knobs
        (BWD_CLUSTER, BWD_THREADS) set; --clocks adds phase clocks: thread
        0 of block 0 records clock64() after each top-level statement of
        the kernel body. Run the other commands from inside the copy.
    python3 tools/bwd_bench.py clocks [B]
        in a --clocks copy: one backward at B trees, then the cycles of
        each statement, and each kernel's device time by torch.profiler
    python3 tools/bwd_bench.py edges [--parent-src FILE]
        every cluster-edge case of tests/test_torch_kernel_launch.py at ten
        times the tied node's features, the kernel, the parent and the
        fp32 plain version each against the fp64 plain version
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

SRC = "src/repro_torch/kernels/csrc/tree_cnn_fused_bwd.cu"
SHAPE = (48, 26, 96)                        # N, F, H at the PPO shapes


def _torch():
    import numpy as np
    import torch
    from repro_torch.kernels import build, ref, tree_conv
    return np, torch, build, ref, tree_conv


def _parent(src: pathlib.Path):
    """An earlier kernel's C entry point, built from `src`."""
    _, _, build, _, _ = _torch()
    so = ROOT / "build" / "parent_bwd" / "libparent.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).tree_cnn_fused_backward
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return fn


def _events(fn, n=200, reps=5):
    np, torch, *_ = _torch()
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _ppo_batch(B, seed=0):
    np, torch, _, _, tree_conv = _torch()
    rng = np.random.default_rng(seed)
    N, F, H = SHAPE

    def cuda(x):
        return torch.from_numpy(x).cuda()
    feat = cuda(rng.standard_normal((B, N, F)).astype(np.float32))
    left = cuda(rng.integers(0, N, (B, N)).astype(np.int32))
    right = cuda(rng.integers(0, N, (B, N)).astype(np.int32))
    mask = cuda((rng.random((B, N)) > 0.25).astype(np.float32))
    params = {l: {w: cuda((rng.standard_normal(
        (F if i == 0 else H, H) if w != "b" else (H,)) * 0.1)
        .astype(np.float32)) for w in tree_conv.WEIGHTS}
        for i, l in enumerate(tree_conv.LAYERS)}
    return (feat, left, right, mask), params, torch.ones((B, H),
                                                         device="cuda")


def cmd_time(args):
    np, torch, _, ref, tree_conv = _torch()
    parent = _parent(pathlib.Path(args.parent_src)) if args.parent_src \
        else None
    new = tree_conv._bwd_library()
    out = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    out["occupancy"] = tree_conv.backward_occupancy(*SHAPE)
    for B in (24, 32):
        batch, params, g = _ppo_batch(B)
        N, F, H = SHAPE
        E = sum(t.numel() for p in params.values() for t in p.values())
        partial = torch.empty((B, E), device="cuda")
        flat = torch.empty(E, device="cuda")
        ptrs = [t.data_ptr() for t in batch]
        for l in tree_conv.LAYERS:
            ptrs += [params[l][w].data_ptr() for w in tree_conv.WEIGHTS]
        ptrs += [g.data_ptr(), partial.data_ptr(), flat.data_ptr(), 0, 0]
        stream = torch.cuda.current_stream().cuda_stream
        fns = {"kernel": lambda: new(*ptrs, B, N, F, H, stream)}
        if parent is not None:
            fns["parent"] = lambda: parent(*ptrs, B, N, F, H, stream)
        want = ref.tree_cnn_fused_bwd_ref(*batch, params, g)[2]
        want = torch.cat([want[l][w].flatten() for l in tree_conv.LAYERS
                          for w in tree_conv.WEIGHTS])
        got = {}
        for k, fn in fns.items():
            if fn() != 0:
                raise RuntimeError(f"{k} failed to launch")
            torch.cuda.synchronize()
            got[k] = flat.clone()
            out[f"B{B}/{k}/limit_share"] = float(
                ((got[k] - want).abs() / (1e-5 + 1e-4 * want.abs())).max())
        if parent is not None:
            out[f"B{B}/bit_equal_to_parent"] = bool(
                torch.equal(got["kernel"], got["parent"]))
        order = list(fns) + list(reversed(fns))
        for k in order:
            out.setdefault(f"B{B}/{k}/ms", []).append(_events(fns[k]))
    print(json.dumps(out))


def cmd_variant(args):
    dst = ROOT / "build" / args.name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
        "build", "*_out", ".git", "__pycache__", ".pytest_cache"))
    p = dst / SRC
    src = p.read_text()
    for kv in args.knobs:
        k, v = kv.split("=")
        src, n = re.subn(rf"#define {k} .*", f"#define {k} {v}", src)
        if n != 1:
            raise SystemExit(f"no knob {k}")
    if args.clocks:
        src = _instrument(src, dst)
    p.write_text(src)
    print(dst)


def _instrument(src: str, dst: pathlib.Path) -> str:
    out, inside, texts = [], False, {}
    for i, ln in enumerate(src.splitlines(), 1):
        out.append(ln)
        if "cg::cluster_group cluster = cg::this_cluster();" in ln:
            inside = True
            out.append("  if (threadIdx.x == 0 && blockIdx.x == 0) "
                       "g_clk[0] = clock64();")
            continue
        if inside and ln.startswith("}"):
            inside = False
        if inside and re.match(r"^  [^ /].*;\s*(//.*)?$", ln) and \
                not ln.lstrip().startswith(("const ", "float* ", "int* ",
                                            "auto ", "float ", "int ",
                                            "return")):
            out.append(f"  if (threadIdx.x == 0 && blockIdx.x == 0) "
                       f"g_clk[{i}] = clock64();")
            texts[i] = ln.strip()[:70]
    (dst / "clk_map.json").write_text(json.dumps(texts))
    body = "\n".join(out) + "\n"
    body = body.replace("namespace {\n",
                        "__device__ long long g_clk[1024];\nnamespace {\n", 1)
    return body + ('extern "C" int bwd_clocks(long long* out) {\n'
                   '  return (int)cudaMemcpyFromSymbol(out, g_clk, '
                   'sizeof(long long) * 1024);\n}\n')


def cmd_clocks(args):
    np, torch, build, _, tree_conv = _torch()
    batch, params, g = _ppo_batch(args.B)

    def call():
        tree_conv.tree_cnn_fused_backward(*batch, params, g,
                                          need_feat=False, need_mask=False)
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    texts = json.loads((ROOT / "clk_map.json").read_text())
    buf = (ctypes.c_longlong * 1024)()
    if build.load("tree_cnn_fused_bwd").bwd_clocks(ctypes.addressof(buf)):
        raise RuntimeError("reading the clocks failed")
    marks = sorted(((buf[i], i) for i in range(1, 1024) if buf[i]))
    prev = t0 = buf[0]
    total = marks[-1][0] - t0
    print(f"B={args.B}: {total} cycles in block 0")
    for t, i in marks:
        print(f"{t - prev:8d} {100 * (t - prev) / total:5.1f}%  "
              f"{texts.get(str(i), '')}")
        prev = t
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us.setdefault(e.name[:60], []).append(e.time_range.elapsed_us())
    print(json.dumps({k: float(np.mean(v)) for k, v in us.items()}))


def cmd_edges(args):
    np, torch, _, ref, tree_conv = _torch()
    import test_torch_kernel_launch as T
    parent = _parent(pathlib.Path(args.parent_src)) if args.parent_src \
        else None
    cuda = torch.device("cuda")

    def outputs(res):
        gf, gm, gp = res
        return [gf, gm] + [gp[l][w] for l in tree_conv.LAYERS
                           for w in tree_conv.WEIGHTS]

    def share(got, want):
        return max(float(((a.double() - b.double()).abs()
                          / (1e-5 + 1e-4 * b.double().abs())).max())
                   for a, b in zip(outputs(got), outputs(want)))

    def run_parent(feat, left, right, mask, params, g):
        B, N, F = feat.shape
        H = g.shape[1]
        E = sum(t.numel() for p in params.values() for t in p.values())
        partial = torch.empty((B, E), device=cuda)
        flat = torch.empty(E, device=cuda)
        gf, gm = torch.empty_like(feat), torch.empty_like(mask)
        ptrs = [t.data_ptr() for t in (feat, left, right, mask)]
        for l in tree_conv.LAYERS:
            ptrs += [params[l][w].data_ptr() for w in tree_conv.WEIGHTS]
        if parent(*ptrs, g.data_ptr(), partial.data_ptr(), flat.data_ptr(),
                  gf.data_ptr(), gm.data_ptr(), B, N, F, H,
                  torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the parent kernel failed to launch")
        gp, at = {l: {} for l in tree_conv.LAYERS}, 0
        for l, w, shape in tree_conv._weight_shapes(F, H):
            n = int(np.prod(shape))
            gp[l][w] = flat[at:at + n].view(shape)
            at += n
        return gf, gm, gp

    rows = []
    for B, N, H, F in itertools.product([1, 24, 32, 33], [1, 16, 48, 64],
                                        [64, 96, 128], [26, 128]):
        (feat, left, right, mask), params, g = T._bwd_case(
            cuda, B, N, F, H, seed=B * N + H + F, tie=N >= 3)
        if B == 1:
            mask[0, : min(N, 2)] = 1.0
        want32 = ref.tree_cnn_fused_bwd_ref(feat, left, right, mask, params,
                                            g)
        p64 = {l: {w: t.double() for w, t in ws.items()}
               for l, ws in params.items()}
        want64 = ref.tree_cnn_fused_bwd_ref(feat.double(), left, right,
                                            mask.double(), p64, g.double())
        row = {"case": [B, N, H, F], "plain32_vs_64": share(want32, want64)}
        got = tree_conv.tree_cnn_fused_backward(feat, left, right, mask,
                                                params, g)
        row["kernel_vs_32"] = share(got, want32)
        row["kernel_vs_64"] = share(got, want64)
        if parent is not None:
            got = run_parent(feat, left, right, mask, params, g)
            row["parent_vs_32"] = share(got, want32)
            row["parent_vs_64"] = share(got, want64)
        rows.append(row)
    over = [r for r in rows if max(v for k, v in r.items()
                                   if k.endswith("_vs_32")) > 1]
    print(json.dumps({"cases": len(rows), "over_limit_vs_32": over}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time")
    t.add_argument("--parent-src")
    v = sub.add_parser("variant")
    v.add_argument("name")
    v.add_argument("knobs", nargs="*")
    v.add_argument("--clocks", action="store_true")
    c = sub.add_parser("clocks")
    c.add_argument("B", type=int, nargs="?", default=24)
    e = sub.add_parser("edges")
    e.add_argument("--parent-src")
    args = ap.parse_args()
    {"time": cmd_time, "variant": cmd_variant, "clocks": cmd_clocks,
     "edges": cmd_edges}[args.cmd](args)


if __name__ == "__main__":
    main()
