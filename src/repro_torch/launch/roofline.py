"""Roofline model for the dry run, as the reference's
`repro.launch.roofline`: three terms from a counted step.

  compute    = FLOPs_per_device / peak_FLOPs_per_chip
  memory     = bytes_per_device / HBM_bw_per_chip
  collective = collective_traffic_per_device / link_bw

FLOPs and bytes come from `launch.opanalysis`, op by op, on the `meta`
device. Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): 989e12 bf16 FLOP/s on the tensor cores,
3.35e12 B/s of HBM3, and 450e9 B/s of NVLink in each direction for the
collective term. The port runs on one card, so that term is 0; the
reference parses its collectives from the compiled HLO text, which the
port does not emit, so nothing here parses collectives.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s
LINK_BW = 450e9              # H100 SXM NVLink, bytes/s each direction


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    model_flops: float = 0.0          # 6*N*D (train) / 2*N*D (serve), global

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs * chips): compute usefulness."""
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.t_bound == 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * self.t_bound)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6ND for train, 2ND for inference-forward. For decode, D = one token
    per sequence (the step processes global_batch tokens)."""
    if shape.kind == "train":
        toks = shape.seq_len * shape.global_batch
        return 6.0 * n_params_active * toks
    if shape.kind == "prefill":
        toks = shape.seq_len * shape.global_batch
        return 2.0 * n_params_active * toks
    return 2.0 * n_params_active * shape.global_batch
