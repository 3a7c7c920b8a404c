"""Plane B plan space: execution-layout knobs for one (arch x shape x mesh)
cell — the distributed-training analogue of AQORA's action space
(DESIGN.md §2, Plane B mapping table):

  attn_mode      "seq" / "heads" / "none"   ~ join-order choice (which axis
                                              the expensive operator shards)
  remat          "full" / "dots" / "none"   ~ materialize-vs-recompute, the
                                              engine's cache/pipeline choice
  ce_chunk       16k..256k                  ~ partition-size tuning
  grad_compress  int8 DP reduction          ~ shuffle compression

Each knob flip is an incremental plan modification from a working baseline
(never a from-scratch plan), evaluated by re-lowering — the same
"constrained action space + stage-level feedback" shape as the paper.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    attn_mode: str = "seq"            # seq | heads | none
    remat: str = "full"               # full | dots | none
    ce_chunk: Optional[int] = None    # None -> lm.CE_CHUNK default (65536)
    grad_compress: bool = False
    attn_remat: bool = False          # flash-bwd: recompute probs in bwd
    mla_absorb: bool = False          # MLA decode: absorbed projections
    attn_scores_bf16: bool = False    # bf16 score/prob HBM traffic
    moe_dispatch: str = "global"      # global | local (block-local scatter)
    kv_seq_shard: bool = False        # decode cache: shard KV seq axis over
                                      # model (flash-decoding) vs head_dim

    def name(self) -> str:
        return (f"attn={self.attn_mode},remat={self.remat},"
                f"ce={self.ce_chunk or 'dflt'},"
                f"gc={'1' if self.grad_compress else '0'},"
                f"ar={'1' if self.attn_remat else '0'},"
                f"ab={'1' if self.mla_absorb else '0'},"
                f"s16={'1' if self.attn_scores_bf16 else '0'},"
                f"moe={self.moe_dispatch},"
                f"kvs={'1' if self.kv_seq_shard else '0'}")

    def neighbors(self, kind: str) -> Iterator["LayoutPlan"]:
        """One-knob flips (the constrained action space)."""
        for m in ("seq", "heads", "none"):
            if m != self.attn_mode:
                yield dataclasses.replace(self, attn_mode=m)
        if kind == "train":
            for r in ("full", "dots"):
                if r != self.remat:
                    yield dataclasses.replace(self, remat=r)
            for c in (16384, 65536, 262144):
                if c != (self.ce_chunk or 65536):
                    yield dataclasses.replace(self, ce_chunk=c)
            yield dataclasses.replace(self, grad_compress=not self.grad_compress)
            yield dataclasses.replace(self, attn_remat=not self.attn_remat)
            yield dataclasses.replace(self,
                                      attn_scores_bf16=not self.attn_scores_bf16)
            yield dataclasses.replace(
                self, moe_dispatch="local" if self.moe_dispatch == "global"
                else "global")
        if kind == "decode":
            yield dataclasses.replace(self, mla_absorb=not self.mla_absorb)
            yield dataclasses.replace(self, kv_seq_shard=not self.kv_seq_shard)


BASELINE = LayoutPlan()
