"""Deterministic cluster latency model (the "6-executor Spark cluster").

The container is a single CPU core, so wall-clock Spark latencies cannot be
measured; instead every stage is charged against this calibrated model.
Magnitudes are chosen so the paper's phenomena reproduce at our data scale:
good plans run in seconds, bad join orders shuffle 10^7-row intermediates
into the minutes/OOM regime, broadcasting a large build side OOMs an
executor, and per-stage scheduling overhead makes extra shuffles visible.
EXPERIMENTS.md validates the paper's *relative* claims under this model.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    n_executors: int = 6
    executor_mem: float = 12e6         # bytes usable for a broadcast build
    bjt: float = 300e3                 # autoBroadcastJoinThreshold (bytes)
    scan_bw: float = 400e6             # bytes/s aggregate
    shuffle_bw: float = 100e6          # bytes/s aggregate (write+read)
    broadcast_bw: float = 150e6        # bytes/s (driver fan-out)
    cpu_rows_per_s: float = 25e6       # aggregate probe/merge throughput
    sort_factor: float = 1.6           # SMJ sort overhead multiplier
    stage_overhead: float = 0.25       # scheduler cost per stage (s)
    shuffle_partition_bytes: float = 16e6
    partition_overhead: float = 0.05   # per shuffle partition (s); AQE
    aqe_coalesce: bool = True          #   coalesces small partitions
    timeout: float = 300.0             # per-query cap (s), as in §VII-A4d
    materialize_cap: int = 10_000_000  # rows; beyond this the join OOMs
    # ---- failure pricing ---------------------------------------------------
    # "timeout": an OOM is charged the full per-query timeout (the original
    #   pricing — the job burns its whole slot before anyone notices).
    # "detect": an OOM is charged at DETECTION time (virtual seconds elapsed
    #   when the executor died) plus `oom_spill_penalty` seconds of spill /
    #   teardown — the failure frees the lane when it actually happens,
    #   which is what makes retry ladders worth their backoff.
    # Injected faults ("crash"/"transient", see serve.recover.faults) are
    # always charged at detection time; a wall-clock "timeout" is always the
    # full timeout. Default preserves bit-identity with the legacy pricing.
    oom_charge: str = "timeout"        # "timeout" | "detect"
    oom_spill_penalty: float = 0.0     # extra seconds charged on detect OOM

    # ---- stage cost terms -------------------------------------------------
    def scan_time(self, bytes_: float) -> float:
        return bytes_ / self.scan_bw

    def shuffle_time(self, bytes_: float) -> float:
        nparts = max(1, int(bytes_ / self.shuffle_partition_bytes))
        if self.aqe_coalesce:
            nparts = min(nparts, 32)
        return bytes_ / self.shuffle_bw + nparts * self.partition_overhead

    def broadcast_time(self, build_bytes: float) -> float:
        return build_bytes * self.n_executors / self.broadcast_bw

    def smj_cpu(self, l_rows: float, r_rows: float, out_rows: float) -> float:
        return (self.sort_factor * (l_rows + r_rows) + out_rows) / self.cpu_rows_per_s

    def bhj_cpu(self, build_rows: float, probe_rows: float, out_rows: float) -> float:
        return (2.0 * build_rows + probe_rows + out_rows) / self.cpu_rows_per_s

    def broadcast_oom(self, build_bytes: float) -> bool:
        return build_bytes > self.executor_mem

    def failure_charge(self, kind: str, elapsed: float) -> float:
        """Virtual seconds a failed run occupies its lane. `elapsed` is the
        simulated time at which the failure was detected."""
        assert self.oom_charge in ("timeout", "detect"), self.oom_charge
        if kind == "timeout":
            return self.timeout
        if kind == "oom" and self.oom_charge == "timeout":
            return self.timeout
        extra = self.oom_spill_penalty if kind == "oom" else 0.0
        return min(self.timeout, elapsed + extra)
