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
  * MIXED  — stage-parallel serving pair (``solve_mixed``): a decode
             micro-batch on the flexible path concurrent with an aligned
             prefill chunk on the aligned path at the same weight site,
             sharing the dual-stream bandwidth pool (Memory-1)

Site classes: the plain decisions cover prefill / decode token counts; the
VERIFY class (``solve_verify``) covers speculative-decoding verification
dispatches, ``lanes`` lanes each scoring its pending token plus K drafts,
an M = lanes*(K+1) matmul, with its own gain account (``verify_gain_us``:
one such dispatch against K+1 M = lanes dispatches, each paying T_sync).
The solver also picks the distributed KV layout for decode
(``solve_kv_mode``: heads against sequence split over the model axis).

The search and its costs are the reference's (``repro.core.solver``). A
table's candidates are priced on the table's spec: on the ``V5E`` default
every decision equals the reference's; on a table measured on the card
(``H100``) the analytic split candidates are priced on the card's spec.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

from .characteristics import (WEIGHT_BYTES_PER_EL, TPUSpec, combine_dual,
                              combine_single, mxu_matmul_parts, sync_cost_us,
                              xla_matmul_parts)
from .profiler import STANDARD_BUCKETS, LatencyTable

ALIGN = 128


@dataclass(frozen=True)
class Decision:
    site: str
    M: int
    strategy: str                  # xla_only | mxu_only | weight | act | hybrid | pad | mixed
    t_us: float
    # weight-centric: n_mxu columns on the aligned path (128-aligned), rest flexible
    n_split: int = 0
    # activation-centric: tokens on the aligned path (a standard bucket)
    m_bucket: int = 0
    ratio: str = ""                # human-readable "mxu:xla" work ratio

    def describe(self) -> str:
        return (f"{self.site}[M={self.M}] -> {self.strategy} "
                f"(n_split={self.n_split}, m_bucket={self.m_bucket}, "
                f"{self.ratio}) {self.t_us:.1f}us")


@dataclass
class PartitionPlan:
    arch: str
    sync_mode: str
    decisions: dict = field(default_factory=dict)   # (site, M) -> Decision
    kv_mode: Optional[str] = None
    # weight storage the plan was solved for (None | int8 | w4a16): the
    # weight stream's bytes move the splits, so plans do not interchange
    weight_quant: Optional[str] = None
    # stage-parallel serving pairs, their own key space so a fused pair
    # (m_prefill + m_decode) never collides with a plain-M decision:
    # (site, m_prefill, m_decode) -> Decision(strategy='mixed')
    mixed_decisions: dict = field(default_factory=dict)
    # speculative-decoding VERIFY class, again its own key space:
    # (site, k, lanes) -> Decision for the M = lanes*(k+1) verification
    verify_decisions: dict = field(default_factory=dict)

    def decision(self, site: str, M: int) -> Optional[Decision]:
        return self.decisions.get((site, M))

    def mixed_decision(self, site: str, m_prefill: int,
                       m_decode: int) -> Optional[Decision]:
        return self.mixed_decisions.get((site, m_prefill, m_decode))

    def verify_decision(self, site: str, k: int,
                        lanes: int = 1) -> Optional[Decision]:
        return self.verify_decisions.get((site, k, lanes))

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
            "kv_mode": self.kv_mode, "weight_quant": self.weight_quant,
            "decisions": [asdict(d) for d in self.decisions.values()],
            "mixed_decisions": [[list(k), asdict(d)] for k, d in
                                self.mixed_decisions.items()],
            "verify_decisions": [[list(k), asdict(d)] for k, d in
                                 self.verify_decisions.items()]}))

    @classmethod
    def load(cls, path) -> "PartitionPlan":
        data = json.loads(Path(path).read_text())
        plan = cls(arch=data["arch"], sync_mode=data["sync_mode"],
                   kv_mode=data.get("kv_mode"),
                   weight_quant=data.get("weight_quant"))
        for d in data["decisions"]:
            dec = Decision(**d)
            plan.decisions[(dec.site, dec.M)] = dec
        for k, d in data.get("mixed_decisions", []):
            plan.mixed_decisions[tuple(k)] = Decision(**d)
        for k, d in data.get("verify_decisions", []):
            plan.verify_decisions[tuple(k)] = Decision(**d)
        return plan


class PartitionSolver:
    def __init__(self, table: LatencyTable, spec: TPUSpec | None = None,
                 *, sync_mode: str = "fast", weight_quant: str | None = None):
        self.table = table
        # the table's own spec unless another is given: a measured H100
        # table prices its analytic candidates on the card's constants
        self.spec = spec if spec is not None else table.spec
        self.sync_mode = sync_mode
        # the weights' storage format; by default the table's, so the
        # table-backed and the analytic candidates price the same bytes
        self.weight_quant = weight_quant if weight_quant is not None \
            else table.weight_quant
        self._w_bpe = WEIGHT_BYTES_PER_EL[self.weight_quant]

    def _mxu_parts(self, M: int, K: int, N: int) -> tuple[float, int]:
        return mxu_matmul_parts(M, K, N, self.spec,
                                w_bytes_per_el=self._w_bpe)

    def _xla_parts(self, M: int, K: int, N: int) -> tuple[float, int]:
        return xla_matmul_parts(M, K, N, self.spec,
                                w_bytes_per_el=self._w_bpe)

    # ---- per-site-and-M strategy search ------------------------------------
    def solve_site(self, site: str, M: int) -> Decision:
        K, N = self.table.sites[site]
        t_sync = sync_cost_us(self.sync_mode, self.spec)
        lut = self.table.lookup

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
                t = combine_dual(self._mxu_parts(Mq, K, n_mxu),
                                 self._xla_parts(M, K, N - n_mxu),
                                 self.spec) + t_sync
                cands.append(Decision(site, M, "weight", t, n_split=n_mxu,
                                      ratio=f"{n_mxu}:{N - n_mxu}"))

        # activation-centric: bucket + remainder (Fig 9), concurrent paths
        for b in (b for b in STANDARD_BUCKETS if b < M):
            rem = M - b
            t = combine_dual(self._mxu_parts(b, K, N),
                             self._xla_parts(rem, K, N), self.spec) + t_sync
            cands.append(Decision(site, M, "act", t, m_bucket=b,
                                  ratio=f"{b}:{rem}tok"))
            # hybrid: also weight-split the bucketed part (§4.2.3)
            if N >= 2 * ALIGN and rem < b // 2:
                for frac in (0.25, 0.5, 0.75):
                    n_mxu = int(round(N * frac / ALIGN)) * ALIGN
                    if not 0 < n_mxu < N:
                        continue
                    cm, bm = self._mxu_parts(b, K, n_mxu)
                    cx1, bx1 = self._xla_parts(b, K, N - n_mxu)
                    cx2, bx2 = self._xla_parts(rem, K, N)
                    t = combine_dual((cm, bm), (cx1 + cx2, bx1 + bx2),
                                     self.spec) + t_sync
                    cands.append(Decision(site, M, "hybrid", t,
                                          n_split=n_mxu, m_bucket=b,
                                          ratio=f"{n_mxu}:{N - n_mxu}w"))
        return min(cands, key=lambda d: d.t_us)

    # ---- stage-parallel (serving) pair --------------------------------------
    def solve_mixed(self, site: str, m_prefill: int, m_decode: int
                    ) -> Decision:
        """Cost the pair the mixed-batch scheduler fuses: ``m_decode``
        decode-lane tokens on the flexible path concurrent with an
        ``m_prefill``-token aligned prefill chunk at this weight site,
        sharing the dual-stream bandwidth pool (``combine_dual``)."""
        K, N = self.table.sites[site]
        t_sync = sync_cost_us(self.sync_mode, self.spec)
        m_pre = -(-m_prefill // ALIGN) * ALIGN        # stage padding
        t = combine_dual(self._mxu_parts(m_pre, K, N),
                         self._xla_parts(m_decode, K, N),
                         self.spec) + t_sync
        return Decision(site, m_prefill + m_decode, "mixed", t,
                        m_bucket=m_prefill,
                        ratio=f"{m_prefill}p:{m_decode}d")

    def mixed_gain_us(self, site: str, m_prefill: int, m_decode: int
                      ) -> float:
        """Predicted latency saved per site by fusing the pair against
        running the two stages back to back (each alone on single-stream
        bandwidth, each paying its own sync)."""
        K, N = self.table.sites[site]
        t_sync = sync_cost_us(self.sync_mode, self.spec)
        m_pre = -(-m_prefill // ALIGN) * ALIGN
        serial = (combine_single(self._mxu_parts(m_pre, K, N),
                                 self.spec) + t_sync
                  + combine_single(self._xla_parts(m_decode, K, N),
                                   self.spec)
                  + t_sync)
        return serial - self.solve_mixed(site, m_prefill, m_decode).t_us

    # ---- speculative-decoding verification ----------------------------------
    def solve_verify(self, site: str, k: int, lanes: int = 1) -> Decision:
        """The VERIFY class: one verification dispatch scores ``lanes``
        lanes x (pending token + k drafts), an M = lanes*(k+1) matmul. The
        search is the standard one, keyed on its own because the scheduler,
        not the request, chooses M (through K)."""
        dec = self.solve_site(site, lanes * (k + 1))
        return Decision(site=site, M=dec.M, strategy=dec.strategy,
                        t_us=dec.t_us, n_split=dec.n_split,
                        m_bucket=dec.m_bucket,
                        ratio=f"verify[k={k},lanes={lanes}]{dec.ratio}")

    def verify_gain_us(self, site: str, k: int, lanes: int = 1) -> float:
        """Predicted latency saved per site by verifying K drafts in ONE
        M = lanes*(k+1) dispatch against k+1 sequential M = lanes decode
        dispatches, each on the flexible path and each paying T_sync."""
        K, N = self.table.sites[site]
        t_sync = sync_cost_us(self.sync_mode, self.spec)
        serial = (k + 1) * (combine_single(
            self._xla_parts(lanes, K, N), self.spec) + t_sync)
        return serial - (self.solve_verify(site, k, lanes).t_us + t_sync)

    # ---- whole-model plan ---------------------------------------------------
    def solve(self, cfg, Ms=(1, 64, 128, 192, 256, 300, 320, 512, 1024,
                             2048, 4096), mixed_pairs=(), verify_ks=(),
              extra_ms=()) -> PartitionPlan:
        """Solve every (site, M) on the grid ``Ms`` plus ``extra_ms`` (e.g.
        a prefix-cache scheduler's suffix-chunk lengths), every
        (m_prefill, m_decode) of ``mixed_pairs`` into
        ``plan.mixed_decisions``, every (k, lanes) of ``verify_ks`` into
        ``plan.verify_decisions``, and the decode KV layout."""
        plan = PartitionPlan(arch=cfg.name, sync_mode=self.sync_mode,
                             weight_quant=self.weight_quant)
        all_ms = sorted(set(Ms) | set(extra_ms))
        for site in self.table.sites:
            for M in all_ms:
                plan.decisions[(site, M)] = self.solve_site(site, M)
            for (mp, md) in mixed_pairs:
                plan.mixed_decisions[(site, mp, md)] = \
                    self.solve_mixed(site, mp, md)
            for (k, lanes) in verify_ks:
                plan.verify_decisions[(site, k, lanes)] = \
                    self.solve_verify(site, k, lanes)
        plan.kv_mode = self.solve_kv_mode(cfg)
        return plan

    # ---- distributed decode layout (mesh-level partitioning) ---------------
    def solve_kv_mode(self, cfg, *, model_ax: int = 16,
                      seq_len: int = 32768, batch_per_dev: int = 8) -> str:
        """KV sharding for decode: heads over the model axis (no collective
        in attention, but replicated KV when n_kv_heads does not divide the
        axis) against sequence-split KV (balanced streams plus a small
        two-pass softmax combine). RWKV keeps a constant-size state and no
        KV to split: 'head'."""
        if cfg.rwkv is not None:
            return "head"
        hd, hkv = cfg.head_dim, cfg.n_kv_heads
        bytes_el = 2
        kv_bytes_tot = 2 * seq_len * hkv * hd * bytes_el * batch_per_dev
        eff = math.gcd(hkv, model_ax)
        bw = self.spec.hbm_bw * self.spec.bw_frac_single
        t_head = (kv_bytes_tot / eff) / bw
        t_seq = (kv_bytes_tot / model_ax) / bw
        coll = 2 * cfg.n_heads * hd * bytes_el * batch_per_dev  # num+den combine
        t_seq += coll / (self.spec.ici_bw * self.spec.ici_links)
        return "head" if t_head <= t_seq else "seq"
