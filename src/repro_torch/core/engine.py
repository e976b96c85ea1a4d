"""Offline phase of the HeteroInfer engine (paper §4.4, Fig 11 left half):
profile the model's weight shapes, solve the per-(site, M) partitioning
decisions, and wrap the plan in the HeteroCtx the models thread through
every matmul.

Engine modes (the paper's evaluation arms):
  'xla'            — flexible path only
  'mxu'            — aligned path only, padded to 128
  'hetero-layer'   — per-op affinity by token count (§4.1)
  'hetero-tensor'  — solver-driven tensor partitioning (§4.2)
"""
from __future__ import annotations

from typing import Optional

from .partition import HeteroCtx
from .profiler import LatencyTable, profile_analytic
from .solver import PartitionPlan, PartitionSolver


def build_plan(cfg, *, sync_mode: str = "fast",
               table: Optional[LatencyTable] = None,
               weight_quant: Optional[str] = None
               ) -> tuple[LatencyTable, PartitionPlan]:
    """Profile (analytic, the reference's cost model) and solve.
    ``weight_quant`` (None | 'int8' | 'w4a16') prices the weight stream at
    the quantized bytes, so a quantized deployment gets its own plan."""
    table = table or profile_analytic(cfg, weight_quant=weight_quant)
    solver = PartitionSolver(table, sync_mode=sync_mode,
                             weight_quant=weight_quant)
    return table, solver.solve(cfg)


def build_hetero_ctx(cfg, mode: str, *, sync_mode: str = "fast",
                     weight_quant: Optional[str] = None) -> HeteroCtx:
    """Profile + solve + wrap in the HeteroCtx covering every matmul site,
    the LM head included."""
    _, plan = build_plan(cfg, sync_mode=sync_mode, weight_quant=weight_quant)
    return HeteroCtx(mode=mode, plan=plan)
