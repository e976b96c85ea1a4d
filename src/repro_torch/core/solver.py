"""Tensor partitioning solver (paper §4.4).

For every matmul site and token count M, enumerate the feasible strategies
and minimize

    T_total = min( max(T_xla^p1, T_mxu^p2) + T_sync + T_copy,
                   T_xla^all,
                   T_mxu^all + T_sync + T_copy )        s.t. p1 + p2 = all

Strategies (paper §4.2):
  * XLA_ONLY / MXU_ONLY — no partition
  * WEIGHT — split N at a 128-aligned ratio; both paths run the full token
             set on complementary output columns (Fig 7)
  * ACT    — tokens split into the largest standard bucket on the aligned
             path + the dynamic remainder on the flexible path (Fig 9)
  * HYBRID — ACT bucketing on tokens + WEIGHT split of the bucketed part
  * PAD    — pad M up to the next bucket, aligned path only

The search and its costs are the reference's (``repro.core.solver``), on
the reference's TPU cost model, so ``decisions`` match it exactly.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

from .characteristics import (WEIGHT_BYTES_PER_EL, TPUSpec, V5E,
                              combine_dual, mxu_matmul_parts, sync_cost_us,
                              xla_matmul_parts)
from .profiler import STANDARD_BUCKETS, LatencyTable

ALIGN = 128


@dataclass(frozen=True)
class Decision:
    site: str
    M: int
    strategy: str                  # xla_only | mxu_only | weight | act | hybrid | pad
    t_us: float
    # weight-centric: n_mxu columns on the aligned path (128-aligned), rest flexible
    n_split: int = 0
    # activation-centric: tokens on the aligned path (a standard bucket)
    m_bucket: int = 0
    ratio: str = ""                # human-readable "mxu:xla" work ratio


@dataclass
class PartitionPlan:
    arch: str
    sync_mode: str
    decisions: dict = field(default_factory=dict)   # (site, M) -> Decision
    # weight storage the plan was solved for (None | int8 | w4a16): the
    # weight stream's bytes move the splits, so plans do not interchange
    weight_quant: Optional[str] = None

    def decision(self, site: str, M: int) -> Optional[Decision]:
        return self.decisions.get((site, M))

    def lookup(self, site: str, M: int) -> Optional[Decision]:
        """The decision governing an M-token dispatch at ``site``: exact when
        M is on the solve grid, else the nearest solved M (the fallback
        HeteroCtx uses). None when the plan has no decisions for the site."""
        dec = self.decisions.get((site, M))
        if dec is not None:
            return dec
        ms = sorted({m for (s, m) in self.decisions if s == site})
        if not ms:
            return None
        return self.decisions[(site, min(ms, key=lambda m: abs(m - M)))]

    def save(self, path) -> None:
        Path(path).write_text(json.dumps({
            "arch": self.arch, "sync_mode": self.sync_mode,
            "weight_quant": self.weight_quant,
            "decisions": [asdict(d) for d in self.decisions.values()]}))

    @classmethod
    def load(cls, path) -> "PartitionPlan":
        data = json.loads(Path(path).read_text())
        plan = cls(arch=data["arch"], sync_mode=data["sync_mode"],
                   weight_quant=data.get("weight_quant"))
        for d in data["decisions"]:
            dec = Decision(**d)
            plan.decisions[(dec.site, dec.M)] = dec
        return plan


class PartitionSolver:
    def __init__(self, table: LatencyTable, spec: TPUSpec = V5E,
                 *, sync_mode: str = "fast", weight_quant: str | None = None):
        self.table = table
        self.spec = spec
        self.sync_mode = sync_mode
        # the weights' storage format; by default the table's, so the
        # table-backed and the analytic candidates price the same bytes
        self.weight_quant = weight_quant if weight_quant is not None \
            else table.weight_quant
        self._w_bpe = WEIGHT_BYTES_PER_EL[self.weight_quant]

    def solve_site(self, site: str, M: int) -> Decision:
        K, N = self.table.sites[site]
        t_sync = sync_cost_us(self.sync_mode, self.spec)
        lut = self.table.lookup
        mxu = lambda m, n: mxu_matmul_parts(                       # noqa: E731
            m, K, n, self.spec, w_bytes_per_el=self._w_bpe)
        xla = lambda m, n: xla_matmul_parts(                       # noqa: E731
            m, K, n, self.spec, w_bytes_per_el=self._w_bpe)

        cands: list[Decision] = []
        aligned_m = M % ALIGN == 0

        # no-partition candidates
        cands.append(Decision(site, M, "xla_only", lut(site, M, "xla"),
                              ratio="0:1"))
        if aligned_m:
            cands.append(Decision(site, M, "mxu_only",
                                  lut(site, M, "mxu") + t_sync, ratio="1:0"))
        else:
            m_pad = -(-M // ALIGN) * ALIGN
            cands.append(Decision(site, M, "pad",
                                  lut(site, m_pad, "mxu") + t_sync,
                                  m_bucket=m_pad, ratio="1:0(pad)"))

        # weight-centric: N split at a 128-aligned point (Fig 7); both paths
        # run concurrently -> memory time uses the dual-stream pool
        if N >= 2 * ALIGN:
            Mq = M if aligned_m else -(-M // ALIGN) * ALIGN  # stage padding
            for frac in (i / 8 for i in range(1, 8)):
                n_mxu = int(round(N * frac / ALIGN)) * ALIGN
                if not 0 < n_mxu < N:
                    continue
                t = combine_dual(mxu(Mq, n_mxu), xla(M, N - n_mxu),
                                 self.spec) + t_sync
                cands.append(Decision(site, M, "weight", t, n_split=n_mxu,
                                      ratio=f"{n_mxu}:{N - n_mxu}"))

        # activation-centric: bucket + remainder (Fig 9), concurrent paths
        for b in (b for b in STANDARD_BUCKETS if b < M):
            rem = M - b
            t = combine_dual(mxu(b, N), xla(rem, N), self.spec) + t_sync
            cands.append(Decision(site, M, "act", t, m_bucket=b,
                                  ratio=f"{b}:{rem}tok"))
            # hybrid: also weight-split the bucketed part (§4.2.3)
            if N >= 2 * ALIGN and rem < b // 2:
                for frac in (0.25, 0.5, 0.75):
                    n_mxu = int(round(N * frac / ALIGN)) * ALIGN
                    if not 0 < n_mxu < N:
                        continue
                    cm, bm = mxu(b, n_mxu)
                    cx1, bx1 = xla(b, N - n_mxu)
                    cx2, bx2 = xla(rem, N)
                    t = combine_dual((cm, bm), (cx1 + cx2, bx1 + bx2),
                                     self.spec) + t_sync
                    cands.append(Decision(site, M, "hybrid", t,
                                          n_split=n_mxu, m_bucket=b,
                                          ratio=f"{n_mxu}:{N - n_mxu}w"))
        return min(cands, key=lambda d: d.t_us)

    def solve(self, cfg, Ms=(1, 64, 128, 192, 256, 300, 320, 512, 1024,
                             2048, 4096)) -> PartitionPlan:
        """Solve every (site, M) on the token-count grid ``Ms``."""
        plan = PartitionPlan(arch=cfg.name, sync_mode=self.sync_mode,
                             weight_quant=self.weight_quant)
        for site in self.table.sites:
            for M in sorted(Ms):
                plan.decisions[(site, M)] = self.solve_site(site, M)
        return plan
