"""The traced steps: `torch.profiler` with device activity only, read back
as kernel intervals, and the reductions every per-layer metric shares.

Only device activity is recorded: a train step launches tens of thousands
of kernels, and reading back the host's events as well takes minutes.
"""
from __future__ import annotations

import time


class Trace:
    """Kernel intervals of `steps` traced steps over `wall_s` seconds of
    host clock: `kernels` [(name, start_ns, end_ns)], sorted by start."""

    def __init__(self, kernels, steps: int, wall_s: float):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.steps = steps
        self.wall_s = wall_s

    def device_s(self, match) -> float:
        """Summed device seconds of the kernels whose name `match` takes."""
        return sum(e - s for n, s, e in self.kernels if match(n)) * 1e-9

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def busy_s(self) -> float:
        """Seconds in which some kernel ran: the union of the intervals
        (a collective's stream overlaps the compute stream)."""
        busy, end = 0, None
        for _, s, e in self.kernels:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def top_ops(self, n=10):
        """[[name, seconds]] of the n kernels that took most time."""
        by = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t * 1e-9] for name, t in top]

    def idle_gaps(self, n=10):
        """[[what, seconds]] of the n longest gaps with no kernel running,
        each named by the kernels on either side of it."""
        gaps, end, last = [], None, None
        for name, s, e in self.kernels:
            if end is not None and s > end:
                gaps.append((s - end, f"after {last[:50]} / before "
                                      f"{name[:50]}"))
            if end is None or e > end:
                end, last = e, name
        gaps.sort(key=lambda g: -g[0])
        return [[what, t * 1e-9] for t, what in gaps[:n]]


def _kernels(prof):
    """(name, start_ns, end_ns) of every device kernel in a finished
    profile."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    return out


def traced(run_steps, steps: int, cpu: bool = False) -> Trace:
    """Profile `run_steps(steps)`, which runs that many steps, each ending
    in a synchronize; returns their Trace. `cpu`: a rehearsal without a
    device, whose trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU if cpu else ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        wall = time.perf_counter() - t0
    return Trace(_kernels(prof), steps, wall)
