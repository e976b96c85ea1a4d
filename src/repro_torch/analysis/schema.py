"""schema-contract: statically cross-check the observability schema the
port emits. The port's counterpart of ``repro.analysis.schema``: the same
four-way check over ``src/repro_torch/serving`` and docs/observability.md,
which describes the port's schema byte for byte as it does the
reference's.

Four artifacts describe the same schema and drift independently:

  1. the ``stats()`` dict literals in both batchers (+ the prefix-cache and
     ingress sub-dicts merged into them),
  2. the literal ``tracer.count("...")`` / ``tracer.gauge("...")`` call
     sites scattered through serving/,
  3. ``STATS_COUNTER_KEYS`` / ``STATS_GAUGE_KEYS`` in serving/trace.py
     (what ``counter_reconciliation()`` reconciles), and
  4. the counter/gauge bullets and dispatch-span table in
     docs/observability.md.

The runtime contract (``counter_reconciliation``) only catches a drift when
a test exercises the drifted counter; this rule proves all four artifacts
agree by construction, for every key, on every commit. It is a *project*
rule: it reads configured files rather than firing per module, so the
fixture tests can point it at a synthetic tree.

Emission sites are collected only from modules under
``SchemaConfig.emission_prefixes`` (the port's package): a tree holding
both packages never lets the reference's call site stand in for a
missing one of the port's.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from .core import Finding, Module, dotted_name, register_rule, resolve


@dataclass(frozen=True)
class StatsSource:
    """One function whose ast.Dict literals are stats key groups."""
    relpath: str
    cls: str          # "" for module-level functions
    func: str
    label: str
    merged: bool      # True if its groups are .update()-merged into the
                      # paged stats dict (must be collision-free); the dense
                      # batcher intentionally mirrors paged keys -> False


@dataclass
class SchemaConfig:
    trace_relpath: str = "src/repro_torch/serving/trace.py"
    docs_relpath: str = "docs/observability.md"
    #: counter names legal at call sites but deliberately NOT in stats()
    #: (trace.py's internal per-kind dispatch counter)
    extra_counters: tuple = ("dispatches",)
    sources: tuple = (
        StatsSource("src/repro_torch/serving/scheduler.py",
                    "ContinuousBatcher", "stats", "dense", merged=False),
        StatsSource("src/repro_torch/serving/scheduler.py", "PagedBatcher",
                    "stats", "paged", merged=True),
        StatsSource("src/repro_torch/serving/paged_cache.py",
                    "PagedKVCache", "prefix_stats", "prefix", merged=True),
        StatsSource("src/repro_torch/serving/ingress.py", "AsyncServer",
                    "stats", "ingress", merged=True),
    )
    #: stats() keys that are snapshots/config, not reconciled counters —
    #: they may appear in stats groups without a tracer emission
    #: (documented in docs/observability.md prose, not the counter bullet)
    snapshot_keys: tuple = ("tp", "spec_k", "draft_model", "acceptance_rate",
                            "total_dispatches", "target_dispatches")
    #: the modules whose tracer call sites count as emissions
    emission_prefixes: tuple = ("src/repro_torch/",)

DEFAULT_CONFIG = SchemaConfig()


# ----------------------------------------------------------- AST extraction

def _find_function(tree: ast.AST, cls: str, func: str):
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if cls and isinstance(node, ast.ClassDef) and node.name == cls:
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub.name == func:
                    return sub
        elif not cls and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == func:
            return node
    return None


def _dict_groups(fn) -> list[tuple[int, set]]:
    """Every all-constant-string-keyed dict literal in ``fn`` as
    (lineno, keyset) — one group per literal, so PagedBatcher.stats yields
    its base dict and its spec ``update({...})`` dict separately."""
    groups = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and node.keys:
            keys = set()
            ok = True
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
                else:
                    ok = False
            if ok:
                groups.append((node.lineno, keys))
    return groups


def _module_tuple(tree: ast.AST, name: str) -> tuple | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                v = ast.literal_eval(node.value)
            except ValueError:
                return None
            return tuple(v), node.lineno
    return None


def _tracer_emissions(modules: list[Module]):
    """Literal tracer call sites across the tree.

    Returns (counts, gauges, kinds): each a dict name -> first (mod, line).
    Receivers must END in ``tracer`` (``self.tracer``, a bare ``tracer``),
    which deliberately excludes trace.py's internal ``self.metrics.count``.
    Dispatch kinds come from ``.dispatch("lit")``, ``._dispatch_span("lit")``,
    ``traced_dispatch(tracer, "lit", ...)`` (core/sync.py's dispatch span
    closed after its fence) and ``.span("lit", ..., cat="sync")``
    (core/sync.py's fused_window)."""
    counts: dict = {}
    gauges: dict = {}
    kinds: dict = {}

    def first_str(call: ast.Call):
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return call.args[0].value
        return None

    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and len(node.args) > 1 \
                    and (resolve(dotted_name(node.func), mod.aliases)
                         or "").rsplit(".", 1)[-1] == "traced_dispatch" \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                kinds.setdefault(node.args[1].value, (mod, node.lineno))
                continue
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            meth = node.func.attr
            recv = dotted_name(node.func.value) or ""
            recv_is_tracer = recv == "tracer" or recv.endswith(".tracer")
            lit = first_str(node)
            if lit is None:
                continue
            if meth in ("count", "gauge") and recv_is_tracer:
                (counts if meth == "count" else gauges).setdefault(
                    lit, (mod, node.lineno))
            elif meth in ("dispatch", "_dispatch_span") and (
                    recv_is_tracer or meth == "_dispatch_span"):
                kinds.setdefault(lit, (mod, node.lineno))
            elif meth == "span" and recv_is_tracer:
                for kw in node.keywords:
                    if kw.arg == "cat" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value == "sync":
                        kinds.setdefault(lit, (mod, node.lineno))
    return counts, gauges, kinds


# ----------------------------------------------------------- docs extraction

_BACKTICK_RE = re.compile(r"`([^`]+)`")


def _doc_bullet_tokens(section: str, bullet_prefix: str) -> set:
    """Identifier tokens inside backticks in the bullet starting with
    ``bullet_prefix`` (tokens are cut at '{' for labeled families like
    ``dispatches{kind=...}``; suffix tokens like ``_total`` are skipped)."""
    m = re.search(re.escape(bullet_prefix) + r".*?(?=\n- |\n\n|\Z)",
                  section, re.S)
    if m is None:
        return set()
    out = set()
    for tok in _BACKTICK_RE.findall(m.group(0)):
        tok = tok.split("{")[0].strip()
        if tok and not tok.startswith("_") \
                and re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", tok):
            out.add(tok)
    return out


def _doc_sections(text: str) -> dict:
    """'## Heading' -> section body text."""
    out = {}
    parts = re.split(r"^## +(.+)$", text, flags=re.M)
    for i in range(1, len(parts) - 1, 2):
        out[parts[i].strip()] = parts[i + 1]
    return out


def _doc_dispatch_names(text: str) -> tuple[set, int]:
    """First-column backtick names from the dispatch-span table (combined
    cells like ``mixed_step`` / ``mixed_window`` split into both)."""
    m = re.search(r"\*\*Dispatch spans\*\*(.*?)(?=\n\*\*|\n## |\Z)",
                  text, re.S)
    if m is None:
        return set(), 0
    line0 = text[:m.start()].count("\n") + 1
    names = set()
    for row in m.group(1).splitlines():
        row = row.strip()
        if not row.startswith("|") or row.startswith("|--") \
                or row.startswith("| name") or row.startswith("|---"):
            continue
        first_cell = row.split("|")[1]
        names.update(_BACKTICK_RE.findall(first_cell))
    return names, line0


# ------------------------------------------------------------------- rule --

@register_rule("schema-contract", kind="project")
def check_schema_contract(root: Path, modules: list[Module],
                          config: SchemaConfig = DEFAULT_CONFIG) -> list:
    """stats() keys, tracer emission sites of the port, STATS_*_KEYS and
    docs/observability.md agree"""
    findings: list = []
    by_path = {m.relpath: m for m in modules}

    def fail(relpath: str, line: int, message: str, snippet: str = ""):
        findings.append(Finding(rule="schema-contract", path=relpath,
                                line=line, message=message, snippet=snippet))

    # --- 3. the trace.py registry -----------------------------------------
    trace_mod = by_path.get(config.trace_relpath)
    if trace_mod is None:
        fail(config.trace_relpath, 1,
             "trace module not found — cannot check the schema contract")
        return findings
    ck = _module_tuple(trace_mod.tree, "STATS_COUNTER_KEYS")
    gk = _module_tuple(trace_mod.tree, "STATS_GAUGE_KEYS")
    if ck is None or gk is None:
        fail(config.trace_relpath, 1,
             "STATS_COUNTER_KEYS / STATS_GAUGE_KEYS tuples not found")
        return findings
    counter_keys, ck_line = set(ck[0]), ck[1]
    gauge_keys, gk_line = set(gk[0]), gk[1]

    # --- 1. stats() dict groups -------------------------------------------
    groups: list[tuple[StatsSource, int, set]] = []
    for src in config.sources:
        mod = by_path.get(src.relpath)
        fn = _find_function(mod.tree, src.cls, src.func) if mod else None
        if fn is None:
            fail(src.relpath, 1,
                 f"stats source {src.cls or '<module>'}.{src.func} not "
                 f"found — update repro_torch/analysis/schema.py's "
                 f"SchemaConfig")
            continue
        for line, keys in _dict_groups(fn):
            groups.append((src, line, keys))
    stats_keys = set().union(*(g[2] for g in groups)) if groups else set()

    # every reconciled key must be produced by some stats() group
    for key in sorted((counter_keys | gauge_keys) - stats_keys):
        fail(config.trace_relpath,
             ck_line if key in counter_keys else gk_line,
             f"STATS key {key!r} is reconciled by counter_reconciliation() "
             f"but no batcher/pool stats() dict produces it")

    # merged groups must be collision-free (they .update() into one dict)
    merged = [(s, ln, keys) for s, ln, keys in groups if s.merged]
    for i, (sa, la, ka) in enumerate(merged):
        for sb, lb, kb in merged[i + 1:]:
            if sa.relpath == sb.relpath and la == lb:
                continue
            for key in sorted(ka & kb):
                fail(sb.relpath, lb,
                     f"stats key {key!r} in {sb.label} group collides with "
                     f"{sa.label} group ({sa.relpath}:{la}) — these dicts "
                     f"merge into one stats() snapshot")

    # --- 2. tracer emission sites -----------------------------------------
    counts, gauges, kinds = _tracer_emissions(
        [m for m in modules
         if any(m.relpath.startswith(p) for p in config.emission_prefixes)])
    legal_counts = counter_keys | set(config.extra_counters)
    for name, (mod, line) in sorted(counts.items()):
        if name not in legal_counts:
            fail(mod.relpath, line,
                 f"tracer.count({name!r}) is not in STATS_COUNTER_KEYS — "
                 f"counter_reconciliation() will never check it",
                 mod.line_at(line))
    for name, (mod, line) in sorted(gauges.items()):
        if name not in gauge_keys:
            fail(mod.relpath, line,
                 f"tracer.gauge({name!r}) is not in STATS_GAUGE_KEYS",
                 mod.line_at(line))
    for key in sorted(counter_keys - set(counts)):
        fail(config.trace_relpath, ck_line,
             f"STATS counter {key!r} has no literal tracer.count() site — "
             f"the metrics ledger can never move for it")
    for key in sorted(gauge_keys - set(gauges)):
        fail(config.trace_relpath, gk_line,
             f"STATS gauge {key!r} has no literal tracer.gauge() site")

    # --- 4. docs/observability.md -----------------------------------------
    docs_path = root / config.docs_relpath
    if not docs_path.exists():
        fail(config.docs_relpath, 1, "observability doc missing")
        return findings
    text = docs_path.read_text()
    sections = _doc_sections(text)
    metrics = sections.get("Metrics exposition", "")
    doc_counters = _doc_bullet_tokens(metrics, "- counters")
    doc_gauges = _doc_bullet_tokens(metrics, "- gauges")
    want_counters = counter_keys | set(config.extra_counters)
    for key in sorted(want_counters - doc_counters):
        fail(config.docs_relpath, 1,
             f"counter {key!r} missing from the docs counters bullet")
    for key in sorted(doc_counters - want_counters):
        fail(config.docs_relpath, 1,
             f"docs list counter {key!r} which the code does not emit")
    for key in sorted(gauge_keys - doc_gauges):
        fail(config.docs_relpath, 1,
             f"gauge {key!r} missing from the docs gauges bullet")
    for key in sorted(doc_gauges - gauge_keys):
        fail(config.docs_relpath, 1,
             f"docs list gauge {key!r} which the code does not emit")

    doc_kinds, table_line = _doc_dispatch_names(text)
    code_kinds = set(kinds)
    for k in sorted(code_kinds - doc_kinds):
        mod, line = kinds[k]
        fail(mod.relpath, line,
             f"dispatch span kind {k!r} is emitted but missing from the "
             f"docs dispatch-span table", mod.line_at(line))
    for k in sorted(doc_kinds - code_kinds):
        fail(config.docs_relpath, table_line,
             f"docs dispatch-span table names {k!r} but no code emits it")
    return findings
