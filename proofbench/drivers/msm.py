"""A ZPrize-shaped variable-base MSM over fixed bases, steps back to back.

Set-up: the bases (a tiling of the SRS's first powers, `inputs/msm.py`) as
the program's gather table (`msm.make_table`, as ZPrize loads its bases
once), and a pool of seeded scalar sets on the device. A step takes the next
`sets_per_step` sets of the pool: `msm.msm_batch_host` over them where the
traffic's path is "batch", `msm.msm_fast_host` (the prover's commit path)
over one where it is "single". The outputs kept are each result's set index
and host point.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import checks
from ..inputs import msm as msm_inputs
from ..inputs import srs as srs_inputs
from ..reference import msm as msm_reference
from ..reference.field import R

UNIT = "points"


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.points = config["bases"]
        self.distinct = config["distinct_bases"]
        self.per_step = traffic["sets_per_step"]
        self.pool = traffic["pool_sets"]
        self.srs_seed = config["srs_seed"].encode()
        self.outputs: List = []
        self.fault = None           # tests and the control plant faults here

    def setup(self) -> Dict:
        from aleo_tpu_torch.curves.g1 import G1Points
        from aleo_tpu_torch.msm import msm

        blob, srs_s = srs_inputs.load(self.config["srs_max_degree"], self.srs_seed)
        d = self.distinct
        pts = [torch.as_tensor(blob[k][:d].astype("int64"), dtype=torch.int32)
               for k in "xyz"]
        pts[2][msm_inputs.IDENTITY_BASE] = 0          # the point at infinity
        one = G1Points(*(t.to(self.device) for t in pts))
        self.table = msm.make_table(one).repeat(self.points // d, 1).contiguous()
        self.scalars = msm_inputs.scalar_sets(self.seed, self.pool, self.points, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return {"srs_generated_s": srs_s}

    def _sets(self, index: int) -> List[int]:
        first = (index * self.per_step) % self.pool
        return list(range(first, first + self.per_step))

    def step(self, index: int) -> int:
        from aleo_tpu_torch.msm import msm

        sets = self._sets(index)
        sc = self.scalars[sets[0]:sets[-1] + 1]
        if self.fault == "top_bit":
            sc = sc.clone()
            sc[..., -1] &= (1 << 12) - 1            # every scalar mod 2^252
        with self.spans.span("msm"):
            if self.traffic["path"] == "batch":
                pts = msm.msm_batch_host(sc, self.table)
            else:
                pts = [msm.msm_fast_host(sc[0], self.table)]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.outputs.append((sets, pts))
        return len(pts) * self.points

    def free(self) -> None:
        self.table = None

    def judge(self) -> List[checks.Check]:
        tau = srs_inputs.trapdoor(self.srs_seed)
        logs = [pow(tau, j, R) for j in range(self.distinct)]
        logs[msm_inputs.IDENTITY_BASE] = 0
        used = sorted({s for sets, _ in self.outputs for s in sets})
        want = {}
        for s in used:
            sums = msm_reference.class_sums(self.scalars[s:s + 1], self.distinct)[0]
            want[s] = msm_reference.expected(sums, logs)
        attempted = wrong = 0
        for sets, pts in self.outputs:
            attempted += len(sets)
            wrong += max(0, len(sets) - len(pts))
            wrong += sum(p != want[s] for s, p in zip(sets, pts))
        self.scalars = None
        return [checks.Check("points_wrong", wrong, 0,
                             "each MSM's point against [sum s_i b_i] G",
                             attempted=attempted)]
