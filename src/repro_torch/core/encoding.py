"""State encoding: compressed plan tree -> padded vector tree (§V-B).

encode(u) = type(u) || table(u) || card(u):
  * type: one-hot {join, base-scan leaf, stage-result leaf} (+broadcast bit)
  * table: 0/1 vector over the workload's TABLE vocabulary — "during AQE
    even leaf nodes may touch multiple tables" (stage results do);
  * card: log1p(observed rows), or -1 when not yet observed; same for
    bytes — runtime statistics only, no histograms/sample bitmaps (S1).

Trees are padded to MAX_NODES with slot 0 reserved as the null child, so a
whole state is (feat [N,F], left [N], right [N], mask [N]) — fixed shapes
for jit. The engine's plans contain ONLY joins and leaves, so the paper's
tree-compression step (dropping sorts/aggregates, Fig. 6(1)) is the
identity here; the table/card encodings are implemented exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sql.executor import RuntimeState
from repro_torch.sql.plans import Join, Leaf, Node, leaves

MAX_NODES = 64


@dataclasses.dataclass(frozen=True)
class WorkloadMeta:
    """Fixed encoding context for one benchmark workload."""
    table_index: Dict[str, int]        # table name -> bit position
    n_tables_max: int                  # max relations in any query (action n)

    @property
    def feat_dim(self) -> int:
        return 4 + len(self.table_index) + 2

    @classmethod
    def from_workload(cls, workload) -> "WorkloadMeta":
        tabs = sorted({r.table for q in workload.train + workload.test
                       for r in q.relations})
        return cls({t: i for i, t in enumerate(tabs)}, workload.max_tables)


def encode_state(state: RuntimeState, meta: WorkloadMeta):
    """RuntimeState -> (feat, left, right, mask) numpy arrays."""
    F = meta.feat_dim
    feat = np.zeros((MAX_NODES, F), np.float32)
    left = np.zeros(MAX_NODES, np.int32)
    right = np.zeros(MAX_NODES, np.int32)
    mask = np.zeros(MAX_NODES, np.float32)
    nT = len(meta.table_index)
    counter = [1]                       # slot 0 = null

    def tab_bits(aliases) -> np.ndarray:
        v = np.zeros(nT, np.float32)
        for a in aliases:
            # unseen tables encode as all-zeros: "even when new tables are
            # introduced, the encoding remains valid, with the corresponding
            # positions taking a default value of 0" (§V-B2)
            i = meta.table_index.get(state.query.relation(a).table)
            if i is not None:
                v[i] = 1.0
        return v

    def visit(node: Node) -> int:
        if counter[0] >= MAX_NODES:
            return 0
        idx = counter[0]
        counter[0] += 1
        mask[idx] = 1.0
        if isinstance(node, Leaf):
            m = state.mats.get(node.covered())
            is_stage = node.stage_id is not None or len(node.aliases) > 1
            feat[idx, 1 if not is_stage else 2] = 1.0
            feat[idx, 3] = 1.0 if node.broadcast_hint else 0.0
            feat[idx, 4:4 + nT] = tab_bits(node.aliases)
            if m is not None:
                feat[idx, 4 + nT] = math.log1p(m.nrows)
                feat[idx, 5 + nT] = math.log1p(m.bytes)
            else:
                feat[idx, 4 + nT] = -1.0
                feat[idx, 5 + nT] = -1.0
            return idx
        feat[idx, 0] = 1.0              # join
        feat[idx, 4:4 + nT] = tab_bits(node.covered())
        feat[idx, 4 + nT] = -1.0        # cardinality not yet observed
        feat[idx, 5 + nT] = -1.0
        left[idx] = visit(node.left)
        right[idx] = visit(node.right)
        return idx

    visit(state.plan)
    return feat, left, right, mask
