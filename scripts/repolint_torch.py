#!/usr/bin/env python
"""repolint-torch CLI — run the port's AST invariant linter.

Usage:
    python scripts/repolint_torch.py --check             # gate (exit 1 on
                                                         # new or stale
                                                         # findings)
    python scripts/repolint_torch.py --list-rules
    python scripts/repolint_torch.py --update-baseline   # regenerate

Pure stdlib + the repro_torch.analysis modules, loaded without importing
the ``repro_torch`` package (whose ``__init__`` imports torch), so it runs
on a bare python with no project dependencies installed.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ANALYSIS = REPO / "src" / "repro_torch" / "analysis"


def _load_analysis():
    """``repro_torch.analysis.core`` with its rules registered, loaded as a
    package of its own so that ``repro_torch/__init__.py`` (torch) is not
    run."""
    name = "repro_torch_analysis"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ANALYSIS / "__init__.py",
            submodule_search_locations=[str(ANALYSIS)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return sys.modules[f"{name}.core"]


core = _load_analysis()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on findings not covered by the "
                         "baseline (and on stale baseline entries)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings to the baseline file")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline path (default: "
                         f"<root>/{core.BASELINE_NAME})")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="repo root to lint (default: this repo)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, (kind, fn) in sorted(core.rule_registry().items()):
            doc = " ".join((fn.__doc__ or "").split())
            print(f"{name:18} [{kind:7}] {doc}")
        print(f"{core.PRAGMA_RULE:18} [{'meta':7}] {core.PRAGMA_RULE_DOC}")
        return 0

    root = args.root.resolve()
    baseline_path = args.baseline or root / core.BASELINE_NAME
    rules = tuple(r.strip() for r in args.rules.split(",")) \
        if args.rules else None

    report = core.run_repolint(root, rules=rules,
                               baseline=core.Baseline.load(baseline_path))

    if args.update_baseline:
        core.Baseline.from_findings(report.findings).save(baseline_path)
        print(f"[repolint-torch] wrote {len(report.findings)} "
              f"fingerprint(s) to {baseline_path}")
        return 0

    for f in report.new:
        print(f.render())
    for fp in report.stale:
        print(f"stale baseline entry (no longer fires): {fp}")
    print(report.summary())
    if not report.ok:
        print("[repolint-torch] FAIL — fix the finding, or suppress with "
              "'# repolint-torch: disable=<rule> -- <reason>' on the "
              "flagged line")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
