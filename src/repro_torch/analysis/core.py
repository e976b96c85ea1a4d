"""repolint-torch infrastructure: findings, pragmas, baseline, walker,
runner. The port's counterpart of ``repro.analysis.core``, standard
library only.

Design notes
------------
* A :class:`Finding` is anchored to a (path, line) but its baseline
  *fingerprint* deliberately excludes the line number — ``path::rule::
  stripped-source-line`` — so unrelated edits above a grandfathered finding
  don't churn the committed baseline.
* Suppression is per-line: ``# repolint-torch: disable=<rule>[,<rule>...]
  -- <reason>`` on the flagged line. The reason is mandatory (a bare pragma
  is itself a finding) and a pragma that suppresses nothing is flagged too,
  so stale suppressions can't linger. The marker differs from the
  reference linter's ``# repolint:``, which walks the port's files too and
  flags a pragma naming a rule it does not know: each linter polices its
  own marker only. The reference's marker is honoured here for
  ``determinism`` alone, the one rule both linters hold under the same
  name and meaning, and is never reported as unknown or unused.
* The baseline file (``.repolint-torch-baseline.json`` at the repo root)
  holds a multiset of fingerprints for grandfathered findings. ``--check``
  fails on findings missing from the baseline AND on baseline entries that
  no longer fire. The committed baseline is empty.
* The walk covers the port: ``src/repro_torch``, ``chip_smoke.py``, and
  the files under ``tests/`` and ``scripts/`` whose imports name
  ``repro_torch``. The reference package is the reference linter's.
"""
from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

# src/repro_torch/analysis/core.py -> repo root
REPO_ROOT = Path(__file__).resolve().parents[3]

# files and directories repolint-torch walks, relative to the repo root
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py", "tests", "scripts")
# of those, the directories whose files are walked only where their
# imports name the port
IMPORT_GATED_ROOTS = ("tests", "scripts")
PORT_PACKAGE = "repro_torch"

BASELINE_NAME = ".repolint-torch-baseline.json"

PRAGMA_MARKER = "repolint-torch"
#: the reference linter's marker, honoured for REFERENCE_PRAGMA_RULES only
REFERENCE_MARKER = "repolint"
REFERENCE_PRAGMA_RULES = ("determinism",)


def _pragma_re(marker: str):
    return re.compile(
        r"#\s*" + re.escape(marker)
        + r":\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:--\s*(.*?)\s*)?$")


_PRAGMA_RES = {m: _pragma_re(m) for m in (PRAGMA_MARKER, REFERENCE_MARKER)}
_IMPORTS_PORT_RE = re.compile(
    r"^\s*(?:from\s+" + PORT_PACKAGE + r"[\s.]|import\s+(?:[\w.]+\s*,\s*)*"
    + PORT_PACKAGE + r"\b)", re.M)


# ---------------------------------------------------------------- findings --

@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    snippet: str = ""  # stripped source line (baseline anchor)

    @property
    def fingerprint(self) -> str:
        return f"{self.path}::{self.rule}::{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Pragma:
    line: int
    rules: tuple
    reason: str
    used: bool = False


def parse_pragmas(source, marker: str = PRAGMA_MARKER) -> dict[int, Pragma]:
    """Per-line ``# <marker>: disable=...`` suppressions (1-based lines).

    Tokenize-based: only actual COMMENT tokens count, so pragma-shaped text
    inside string literals (fixture snippets in tests) is ignored. Accepts
    the module source string, or a list of lines for convenience."""
    if not isinstance(source, str):
        source = "\n".join(source) + "\n"
    pattern = _PRAGMA_RES.get(marker) or _pragma_re(marker)
    out: dict[int, Pragma] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = pattern.search(tok.string)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                line = tok.start[0]
                out[line] = Pragma(line=line, rules=rules,
                                   reason=(m.group(2) or "").strip())
    except (tokenize.TokenError, IndentationError):
        pass   # unparseable files never reach the rules either
    return out


# ----------------------------------------------------------------- modules --

@dataclass
class Module:
    """One parsed source file handed to every per-module rule."""
    path: Path
    relpath: str                 # posix, repo-relative
    source: str
    lines: list[str]
    tree: ast.AST
    aliases: dict = field(default_factory=dict)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 0))
        return Finding(rule=rule, path=self.relpath, line=line,
                       message=message, snippet=self.line_at(line))


def module_name(relpath: str) -> tuple[str, bool]:
    """(dotted module name, is a package ``__init__``) of a repo-relative
    path, with a leading ``src/`` dropped: ``src/repro_torch/core/sync.py``
    -> ``repro_torch.core.sync``."""
    parts = relpath[:-3].split("/") if relpath.endswith(".py") \
        else relpath.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


def build_alias_map(tree: ast.AST, module: str = "",
                    is_package: bool = False) -> dict:
    """Local name -> canonical dotted prefix, from the module's imports
    (``import numpy as np`` -> np: numpy; ``from time import sleep as zz``
    -> zz: time.sleep). A relative import resolves against ``module``
    (``from ..core.sync import stage`` in ``repro_torch.serving.scheduler``
    -> stage: repro_torch.core.sync.stage): the port imports its own
    modules relatively. Resolution is textual — no imports are executed."""
    aliases: dict[str, str] = {}
    package = module.split(".") if is_package else module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module
            elif module and node.level <= len(package):
                base = ".".join(package[:len(package) - node.level + 1]
                                + ([node.module] if node.module else []))
            else:
                continue
            if not base:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve(name: Optional[str], aliases: dict) -> Optional[str]:
    """Canonicalize a dotted name through the module's import aliases."""
    if name is None:
        return None
    head, _, rest = name.partition(".")
    base = aliases.get(head)
    if base is None:
        return name
    return f"{base}.{rest}" if rest else base


def load_module(path: Path, root: Path) -> Optional[Module]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    rel = path.relative_to(root).as_posix()
    name, is_package = module_name(rel)
    return Module(path=path, relpath=rel, source=source,
                  lines=source.splitlines(), tree=tree,
                  aliases=build_alias_map(tree, name, is_package))


def imports_port(path: Path) -> bool:
    """Whether the file's import statements name ``repro_torch``."""
    try:
        return bool(_IMPORTS_PORT_RE.search(path.read_text()))
    except (UnicodeDecodeError, OSError):
        return False


def walk_tree(root: Path | str | None = None,
              roots: Iterable[str] = DEFAULT_ROOTS) -> list[Path]:
    """The walked files under ``root``: every ``*.py`` of each of ``roots``
    (a directory or a file), those of IMPORT_GATED_ROOTS only where their
    imports name the port."""
    root = Path(root) if root is not None else REPO_ROOT
    files: list[Path] = []
    for sub in roots:
        base = root / sub
        if base.is_file() and base.suffix == ".py":
            files.append(base)
        elif base.is_dir():
            found = sorted(base.rglob("*.py"))
            if sub in IMPORT_GATED_ROOTS:
                found = [p for p in found if imports_port(p)]
            files.extend(found)
    return files


# ---------------------------------------------------------------- baseline --

class Baseline:
    """Multiset of grandfathered finding fingerprints."""

    def __init__(self, counts: Counter | None = None):
        self.counts: Counter = counts or Counter()

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        return cls(Counter(data.get("fingerprints", [])))

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        return cls(Counter(f.fingerprint for f in findings))

    def save(self, path: Path) -> None:
        fps = sorted(self.counts.elements())
        path.write_text(json.dumps({"version": 1, "fingerprints": fps},
                                   indent=1) + "\n")

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[str]]:
        """(new findings not covered by the baseline, stale baseline
        entries that no longer fire). Duplicates are consumed count-wise."""
        budget = Counter(self.counts)
        new = []
        for f in findings:
            if budget[f.fingerprint] > 0:
                budget[f.fingerprint] -= 1
            else:
                new.append(f)
        stale = sorted(budget.elements())
        return new, stale


# ------------------------------------------------------------------ runner --

#: registry: rule name -> (kind, fn). Per-module rules get one Module;
#: project rules get (root, list[Module]) and may read non-Python files.
_RULES: dict[str, tuple[str, Callable]] = {}


def register_rule(name: str, kind: str = "module"):
    assert kind in ("module", "project"), kind

    def deco(fn):
        _RULES[name] = (kind, fn)
        return fn
    return deco


def rule_registry() -> dict:
    _ensure_rules_loaded()
    return dict(_RULES)


_RULES_LOADED = False


def _ensure_rules_loaded():
    # deferred: rules.py/schema.py import core for the registry decorator
    global _RULES_LOADED
    if not _RULES_LOADED:
        from . import rules, schema   # noqa: F401  (registration side effect)
        _RULES_LOADED = True


RULE_NAMES = ("use-after-replay", "determinism", "capture-hygiene",
              "host-sync", "schema-contract")
#: meta-rule for pragma hygiene (bare / unknown / unused pragmas);
#: emitted by run_repolint itself, not suppressible.
PRAGMA_RULE = "pragma"
PRAGMA_RULE_DOC = ("a '# repolint-torch:' pragma with no reason, naming an "
                   "unknown rule, or suppressing nothing")


@dataclass
class Report:
    findings: list[Finding]          # after pragma suppression (incl. meta)
    new: list[Finding]               # findings not covered by the baseline
    stale: list[str]                 # baseline entries that no longer fire
    suppressed: int
    n_files: int

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale

    def summary(self) -> str:
        per_rule = Counter(f.rule for f in self.findings)
        rules = ", ".join(f"{r}={n}" for r, n in sorted(per_rule.items())) \
            or "none"
        return (f"[repolint-torch] {self.n_files} files, "
                f"{len(self.findings)} findings ({rules}), "
                f"{self.suppressed} suppressed by pragma, "
                f"{len(self.new)} new vs baseline, "
                f"{len(self.stale)} stale baseline entries")


def run_repolint(root: Path | str | None = None, *,
                 rules: Iterable[str] | None = None,
                 roots: Iterable[str] = DEFAULT_ROOTS,
                 baseline: Baseline | str | Path | None = None) -> Report:
    """Walk ``roots`` under ``root``, run ``rules`` (default: all), apply
    per-line pragmas, and diff raw findings against the baseline."""
    _ensure_rules_loaded()
    root = Path(root) if root is not None else REPO_ROOT
    selected = tuple(rules) if rules is not None else tuple(_RULES)
    unknown = [r for r in selected if r not in _RULES]
    if unknown:
        raise ValueError(f"unknown rule(s): {unknown}; "
                         f"known: {sorted(_RULES)}")
    if baseline is None:
        baseline = Baseline.load(root / BASELINE_NAME)
    elif not isinstance(baseline, Baseline):
        baseline = Baseline.load(Path(baseline))

    modules = [m for m in (load_module(p, root)
                           for p in walk_tree(root, roots)) if m]
    raw: list[Finding] = []
    for name in selected:
        kind, fn = _RULES[name]
        if kind == "module":
            for mod in modules:
                raw.extend(fn(mod))
        else:
            raw.extend(fn(root, modules))

    by_path: dict[str, list[Finding]] = {}
    for f in raw:
        by_path.setdefault(f.path, []).append(f)
    findings, suppressed = [], 0
    metas: list[Finding] = []
    for mod in modules:
        pragmas = parse_pragmas(mod.source)
        reference = parse_pragmas(mod.source, REFERENCE_MARKER)
        for p in pragmas.values():
            for r in p.rules:
                if r not in _RULES:
                    metas.append(mod.finding(
                        PRAGMA_RULE, p.line,
                        f"pragma names unknown rule {r!r}"))
            if not p.reason:
                metas.append(mod.finding(
                    PRAGMA_RULE, p.line,
                    "pragma has no reason — write "
                    "'# repolint-torch: disable=<rule> -- <why>'"))
        for f in by_path.get(mod.relpath, ()):
            p = pragmas.get(f.line)
            ref = reference.get(f.line)
            if p is not None and f.rule in p.rules:
                p.used = True
                suppressed += 1
            elif ref is not None and f.rule in ref.rules \
                    and f.rule in REFERENCE_PRAGMA_RULES:
                suppressed += 1
            else:
                findings.append(f)
        for p in pragmas.values():
            if not p.used and all(r in _RULES for r in p.rules):
                metas.append(mod.finding(
                    PRAGMA_RULE, p.line,
                    f"unused pragma (suppresses no "
                    f"{'/'.join(p.rules)} finding) — remove it"))
    # project-rule findings on non-module files (e.g. docs/*.md) pass through
    seen_paths = {m.relpath for m in modules}
    findings.extend(f for f in raw if f.path not in seen_paths)
    findings.extend(metas)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    new, stale = baseline.split(findings)
    return Report(findings=findings, new=new, stale=stale,
                  suppressed=suppressed, n_files=len(modules))
