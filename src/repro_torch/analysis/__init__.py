"""repolint-torch — the port's repo-custom static analysis over Python ASTs.

The port's disciplines (a CUDA graph's outputs copied before the next
replay overwrites them, a paged pool's tensors kept in place, loops
captured once per key, ``fence`` the one sync site, no host pull inside a
captured body, zero wall-clock outside the injectable Clock, a
collision-free stats()/metrics schema) were kept by convention, and a CPU
run cannot break them: ``make_loop`` returns the body itself there. This
package proves them statically over the port's files, before anything
runs:

  * :mod:`repro_torch.analysis.core`   — findings, per-line pragmas
    (``# repolint-torch: disable=<rule> -- <reason>``), baseline, file
    walker, and the :func:`run_repolint` runner.
  * :mod:`repro_torch.analysis.rules`  — the AST rules: ``determinism``,
    ``host-sync``, ``capture-hygiene``, ``use-after-replay``.
  * :mod:`repro_torch.analysis.schema` — the project-level
    ``schema-contract`` rule cross-checking stats() keys, the port's
    tracer counter names, ``STATS_COUNTER_KEYS`` and
    docs/observability.md.

Standard library only: no torch, and nothing of the reference package.
Entry point: ``scripts/repolint_torch.py`` (``--check``).
"""
from .core import (Baseline, Finding, Report, RULE_NAMES, run_repolint,
                   walk_tree)

__all__ = ["Baseline", "Finding", "Report", "RULE_NAMES", "run_repolint",
           "walk_tree"]
