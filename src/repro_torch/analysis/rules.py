"""Per-module AST rules: determinism, host-sync, capture-hygiene,
use-after-replay.

The port's counterparts of ``repro.analysis.rules``. Where the reference's
rules prove something about ``jax.jit``, donation and traced bodies, these
prove the same kind of thing about CUDA graphs and torch:

* ``determinism`` — the reference's banned clocks and global RNGs, plus
  torch's global RNG.
* ``host-sync`` — ``.synchronize()`` only at the sanctioned sites, and no
  host pull inside a captured loop body (``jit-hygiene``'s traced bodies).
* ``capture-hygiene`` (``jit-hygiene``) — graph capture only in
  ``core/sync.py``; loops built once per key, never per iteration or per
  step; a loop's arguments staged, never built inline from host data.
* ``use-after-replay`` (``use-after-donate``) — a loop's outputs are static
  buffers that its next replay overwrites: copied before they escape or
  outlive a later replay. A paged pool-carrying function keeps its pool's
  tensors: a graph captured over them would write stale storage if the
  pool it returned were new.

Every rule is intentionally repo-custom: allowlists and name patterns
encode THIS codebase's conventions (the injectable Clock in
serving/telemetry.py, ``fence`` and the graph runner in core/sync.py, the
loop factories there, the pool-carrying paged entry points). Rules resolve
names through the module's import aliases (relative imports included) and
track only what can be decided locally, so a clean report means the
discipline provably holds at every site the rule can see.
"""
from __future__ import annotations

import ast
import re
import weakref
from dataclasses import dataclass, field
from typing import Optional

from .core import Module, dotted_name, register_rule, resolve

SYNC_MODULE = "repro_torch.core.sync"
SYNC_RELPATH = "src/repro_torch/core/sync.py"


def _allowed(relpath: str, prefixes: tuple) -> bool:
    return any(relpath == p or relpath.startswith(p) for p in prefixes)


def _dedupe(findings: list) -> list:
    """Keep the first finding per (line, message): ``a.b`` inside ``a.b.c``
    walks both nodes."""
    seen, out = set(), []
    for f in findings:
        key = (f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _sync_short(func: ast.AST, mod: Module) -> Optional[str]:
    """``X`` where ``func`` names ``repro_torch.core.sync.X`` (imported,
    or a bare name inside core/sync.py itself), else None."""
    d = dotted_name(func)
    if d is None:
        return None
    name = resolve(d, mod.aliases)
    if name.startswith(SYNC_MODULE + ".") \
            and name.count(".") == SYNC_MODULE.count(".") + 1:
        return name.rsplit(".", 1)[1]
    if mod.relpath == SYNC_RELPATH and "." not in d:
        return d
    return None


# =========================================================== determinism ====
#
# Ban ambient wall-clock / RNG outside the injectable Clock. The tier-1
# determinism contract (telemetry.FakeClock, seeded generators) only holds
# if nothing reads the real clock or global RNG state behind its back.
# Allowlist: serving/telemetry.py IS the clock (time.monotonic), and
# chip_smoke.py and the port's scripts/ measure the card by definition
# (perf_counter only — never sleep), as benchmarks/ does in the reference.

_TELEMETRY = ("src/repro_torch/serving/telemetry.py",)
_MEASURES = ("chip_smoke.py", "scripts/")
_DETERMINISM_BANNED = {
    "time.time": (),
    "time.sleep": (),
    "time.monotonic": _TELEMETRY,
    "time.monotonic_ns": _TELEMETRY,
    "time.perf_counter": _MEASURES,
    "time.perf_counter_ns": _MEASURES,
    "datetime.datetime.now": (),
    "datetime.datetime.utcnow": (),
    "datetime.datetime.today": (),
    "datetime.date.today": (),
    # torch's global RNG: seeding it is ambient state too
    "torch.manual_seed": (),
    "torch.cuda.manual_seed": (),
    "torch.cuda.manual_seed_all": (),
    # the *_like draws take no generator: always the global RNG
    "torch.rand_like": (),
    "torch.randn_like": (),
    "torch.randint_like": (),
}
# global-state RNGs: the stdlib random module and numpy's legacy module-
# level API. Seeded generator objects (np.random.default_rng(seed),
# torch.Generator().manual_seed(seed)) are the sanctioned sources.
_LEGACY_NP_RANDOM = {
    "seed", "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "standard_normal",
}
# torch draws that read the global RNG unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register_rule("determinism")
def check_determinism(mod: Module) -> list:
    """ambient clocks, stdlib / legacy numpy RNGs and torch's global RNG
    outside the injectable Clock"""
    findings = []

    def flag(node, name):
        findings.append(mod.finding(
            "determinism", node,
            f"{name} is banned outside the injectable Clock "
            f"(serving/telemetry.py) — thread a Clock through, or pragma "
            f"with a reason"))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and not _has_generator(node):
            name = resolve(dotted_name(node.func), mod.aliases)
            if name is not None and name.startswith("torch.") \
                    and name.count(".") == 1 \
                    and name.split(".")[1] in _TORCH_DRAWS:
                flag(node, name + " without generator= (torch's global "
                     "RNG; pass a seeded torch.Generator)")
            continue
        name = None
        if isinstance(node, (ast.Attribute, ast.Name)):
            name = resolve(dotted_name(node), mod.aliases)
        if name is None:
            continue
        if name in _DETERMINISM_BANNED:
            if not _allowed(mod.relpath, _DETERMINISM_BANNED[name]):
                flag(node, name)
        elif name.startswith("random.") and name.count(".") == 1:
            flag(node, name)
        elif name.startswith("numpy.random.") \
                and name.rsplit(".", 1)[1] in _LEGACY_NP_RANDOM:
            flag(node, name + " (global-state RNG; use "
                 "np.random.default_rng(seed))")
    return _dedupe(findings)


# ================================================================= loops ====
#
# Shared by capture-hygiene and use-after-replay: which expressions of a
# module are decode loops or captured calls (``make_loop`` / ``CapturedLoop``
# / ``make_call`` results, which on the card replay one CUDA graph per
# call).

#: core/sync.py's loop constructors and factories (each returns make_loop's
#: result); ``generate_host_loop`` only runs a loop
LOOP_FACTORIES = ("make_loop", "CapturedLoop", "decode_loop",
                  "paged_window_loop", "paged_step_loop",
                  "paged_mixed_window_loop", "paged_mixed_step_loop",
                  "slot_decode_loop", "make_call", "CapturedCall")
#: core/sync.py's functions that call their first argument, a loop, and
#: return its outputs as they are (the caller copies them)
REPLAY_FORWARDERS = ("window_replay",)
_LOOP_PARAM_RE = re.compile(r"(^|_)loop$")

_FN = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(fn):
    """The nodes of ``fn``'s own frame: nested defs and classes excluded."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (*_FN, ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _frames(mod: Module) -> list:
    """(def or None for the module, enclosing class name, the frame's own
    nodes) of every frame of the module, computed once per Module."""
    frames = mod.__dict__.get("_frames")
    if frames is None:
        frames = [(None, "", list(_own_nodes(mod.tree)))]
        frames += [(fn, cls, list(_own_nodes(fn)))
                   for fn, cls in _collect_functions(mod.tree)]
        mod.__dict__["_frames"] = frames
    return frames


def _collect_functions(tree) -> list:
    out = []

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, _FN):
                out.append((child, cls))
                visit(child, cls)
            else:
                visit(child, cls)
    visit(tree, "")
    return out


@dataclass
class LoopBindings:
    """Names, containers and functions that hold or return decode loops."""
    mod: Module
    names: dict = field(default_factory=dict)       # scope -> {dotted}
    containers: dict = field(default_factory=dict)  # scope -> {dotted}
    returners: dict = field(default_factory=dict)   # scope -> {callee}

    # a scope is id(fn) for locals, ("class", name) for self.*, "module"
    def _scopes(self, fn, cls):
        return ([id(fn)] if fn is not None else []) \
            + ([("class", cls)] if cls else []) + ["module"]

    def _in(self, table, d, fn, cls) -> bool:
        return any(d in table.get(s, ()) for s in self._scopes(fn, cls))

    def is_factory_call(self, node) -> bool:
        return isinstance(node, ast.Call) \
            and _sync_short(node.func, self.mod) in LOOP_FACTORIES

    def is_loop(self, expr, fn, cls) -> bool:
        if self.is_factory_call(expr):
            return True
        if isinstance(expr, ast.Call):
            d = dotted_name(expr.func)
            return d is not None and self._in(self.returners, d, fn, cls)
        if isinstance(expr, (ast.Name, ast.Attribute)):
            d = dotted_name(expr)
            return d is not None and self._in(self.names, d, fn, cls)
        if isinstance(expr, ast.Subscript):
            d = dotted_name(expr.value)
            return d is not None and self._in(self.containers, d, fn, cls)
        if isinstance(expr, ast.IfExp):
            return self.is_loop(expr.body, fn, cls) \
                or self.is_loop(expr.orelse, fn, cls)
        return False

    def loop_call(self, call: ast.Call, fn, cls) -> Optional[str]:
        """The loop ``call`` replays (its name), if it calls one: directly,
        or through a replay forwarder (``window_replay(loop, ...)``)."""
        if self.is_loop(call.func, fn, cls):
            return f"{dotted_name(call.func) or 'loop'}()"
        short = _sync_short(call.func, self.mod)
        if short in REPLAY_FORWARDERS and call.args \
                and self.is_loop(call.args[0], fn, cls):
            return f"{short}({dotted_name(call.args[0]) or 'loop'}, ...)"
        return None


def _bind_scope(d: str, fn, cls):
    if d.startswith("self.") and cls:
        return ("class", cls)
    if fn is None:
        return "module"
    return id(fn)


def collect_loop_bindings(mod: Module) -> LoopBindings:
    """The module's loop bindings, computed once per Module (capture-hygiene
    and use-after-replay share them)."""
    lb = mod.__dict__.get("_loop_bindings")
    if lb is None:
        lb = mod.__dict__["_loop_bindings"] = _collect_loop_bindings(mod)
    return lb


def _collect_loop_bindings(mod: Module) -> LoopBindings:
    # a proxy: the Module caches its bindings, which must not keep it alive
    lb = LoopBindings(weakref.proxy(mod))
    frames = _frames(mod)
    for fn, _, _ in frames[1:]:
        params = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        lb.names.setdefault(id(fn), set()).update(
            a.arg for a in params if _LOOP_PARAM_RE.search(a.arg))
    changed = True
    while changed:
        changed = False

        def add(table, scope, d):
            nonlocal changed
            bucket = table.setdefault(scope, set())
            if d not in bucket:
                bucket.add(d)
                changed = True

        for fn, cls, nodes in frames:
            for node in nodes:
                if isinstance(node, ast.Assign) \
                        and lb.is_loop(node.value, fn, cls):
                    for t in node.targets:
                        if isinstance(t, (ast.Name, ast.Attribute)):
                            d = dotted_name(t)
                            if d:
                                add(lb.names, _bind_scope(d, fn, cls), d)
                        elif isinstance(t, ast.Subscript):
                            d = dotted_name(t.value)
                            if d:
                                add(lb.containers,
                                    _bind_scope(d, fn, cls), d)
                elif isinstance(node, ast.Return) and fn is not None \
                        and node.value is not None \
                        and lb.is_loop(node.value, fn, cls):
                    if cls:
                        add(lb.returners, ("class", cls), f"self.{fn.name}")
                    else:
                        add(lb.returners, "module", fn.name)
    return lb


# ======================================================= capture-hygiene ====
#
# A CUDA graph is captured once and replayed: capture is costly (a warm-up
# run, the capture, a private memory pool) and, done wrong, corrupts what it
# captures. Three checks:
#   1. torch.cuda.graph / CUDAGraph / make_graphed_callables only in
#      core/sync.py (CapturedLoop), where capture's rules are kept once.
#   2. No loop is built inside a for/while or a per-call function (the
#      reference's _HOT_FN_RE): build once per key, under
#      ``if key not in <cache>: <cache>[key] = ...``.
#   3. In library code, a loop's arguments are staged (core.sync.stage:
#      page-locked), never built inline from host data, whose copy into the
#      graph's static buffers would wait for the host.

_GRAPH_NAMES = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                "torch.cuda.make_graphed_callables",
                "torch.cuda.graphs.graph", "torch.cuda.graphs.CUDAGraph",
                "torch.cuda.graphs.make_graphed_callables"}
_GRAPH_ALLOWED = (SYNC_RELPATH,)
_HOT_FN_RE = re.compile(r"(^_?(step|tick)$)|(_step$)|(_tick$)|(^generate)")
_HOT_FN_EXEMPT = ("build_", "make_", "create_", "test_",
                  "_build_", "_make_", "_create_")
_HOST_SOURCES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
_STAGING_CHECK_PREFIXES = ("src/repro_torch/",)


def _is_hot_fn(name: str) -> bool:
    return bool(_HOT_FN_RE.search(name)) \
        and not name.startswith(_HOT_FN_EXEMPT)


def _guarded_caches(test: ast.AST) -> set:
    """C for every ``... not in C`` inside an if-test."""
    out = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, ast.NotIn):
                    d = dotted_name(comp)
                    if d:
                        out.add(d)
    return out


def _assigns_into(stmts, caches: set) -> bool:
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and dotted_name(t.value) in caches:
                        return True
    return False


def _host_built(expr, aliases) -> bool:
    """An expression built inline from host data: torch.tensor /
    as_tensor / from_numpy, through any method chain but .pin_memory()."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_host_built(e, aliases) for e in expr.elts)
    if isinstance(expr, ast.Starred):
        return _host_built(expr.value, aliases)
    if not isinstance(expr, ast.Call):
        return False
    if resolve(dotted_name(expr.func), aliases) in _HOST_SOURCES:
        return True
    if isinstance(expr.func, ast.Attribute):
        if expr.func.attr == "pin_memory":
            return False
        return _host_built(expr.func.value, aliases)
    return False


class _BuildSites(ast.NodeVisitor):
    """capture-hygiene check 2: loop factories called inside a for / while
    or a hot function, outside an ``if key not in <cache>`` guard."""

    def __init__(self, mod: Module, lb: LoopBindings, findings: list):
        self.mod, self.lb, self.findings = mod, lb, findings
        self.loop_depth = 0
        self.guarded = 0
        self.fn_stack: list[str] = []

    def visit_For(self, node):
        self._loop(node)

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self._loop(node)

    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_If(self, node):
        self.visit(node.test)
        caches = _guarded_caches(node.test)
        guard = bool(caches) and _assigns_into(node.body, caches)
        self.guarded += guard
        for stmt in node.body:
            self.visit(stmt)
        self.guarded -= guard
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_FunctionDef(self, node):
        self.fn_stack.append(node.name)
        # a def's body runs when called, not where it is defined
        saved, self.loop_depth = self.loop_depth, 0
        saved_guard, self.guarded = self.guarded, 0
        for d in node.decorator_list:
            self.visit(d)
        for stmt in node.body:
            self.visit(stmt)
        self.loop_depth, self.guarded = saved, saved_guard
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        if self.lb.is_factory_call(node) and not self.guarded:
            what = _sync_short(node.func, self.mod)
            if self.loop_depth > 0:
                self.findings.append(self.mod.finding(
                    "capture-hygiene", node,
                    f"{what} built inside a loop — every iteration "
                    f"captures a fresh CUDA graph (warm-up, capture, "
                    f"its own memory pool); build it once per key"))
            elif self.fn_stack and _is_hot_fn(self.fn_stack[-1]):
                self.findings.append(self.mod.finding(
                    "capture-hygiene", node,
                    f"{what} built inside per-call function "
                    f"{self.fn_stack[-1]!r} — a capture on every call; "
                    f"keep the loop per key (if key not in cache)"))
        self.generic_visit(node)


@register_rule("capture-hygiene")
def check_capture_hygiene(mod: Module) -> list:
    """graph capture only in core/sync.py; loops built once per key, not
    per iteration or step; loop arguments staged, not built from host data"""
    findings = []
    # 1. graph capture outside core/sync.py
    if not _allowed(mod.relpath, _GRAPH_ALLOWED):
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = resolve(dotted_name(node), mod.aliases)
                if name in _GRAPH_NAMES:
                    findings.append(mod.finding(
                        "capture-hygiene", node,
                        f"{name} outside core/sync.py — capture through "
                        f"core.sync.make_loop / make_call, which keep "
                        f"capture's rules (warm-up, private pool, no GC)"))
    lb = collect_loop_bindings(mod)

    # 2. loops built per iteration or per call
    _BuildSites(mod, lb, findings).visit(mod.tree)

    # 3. host-built arguments at a loop call (library code)
    if _allowed(mod.relpath, _STAGING_CHECK_PREFIXES):
        for fn, cls, nodes in _frames(mod)[1:]:
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                callee = lb.loop_call(node, fn, cls)
                if callee is None:
                    continue
                if lb.is_loop(node.func, fn, cls):
                    args = list(node.args) + [k.value for k in node.keywords]
                else:       # a forwarder: its inputs argument
                    args = node.args[1:2] + [k.value for k in node.keywords
                                             if k.arg == "inputs"]
                if any(_host_built(a, mod.aliases) for a in args):
                    findings.append(mod.finding(
                        "capture-hygiene", node,
                        f"{callee} gets an argument built inline from "
                        f"host data — its copy into the graph's buffers "
                        f"waits for the host; stage it (core.sync.stage)"))
    return _dedupe(findings)


# ============================================================= host-sync ====
#
# The paper's thesis: unplanned host<->device synchronization points are
# where heterogeneous engines lose. Two checks:
#   1. .synchronize() (torch.cuda's, a stream's, an event's) only at the
#      sanctioned sync site (core/sync.py's fence) and where the card is
#      measured (chip_smoke.py, scripts/).
#   2. Inside a captured body — the first argument of make_loop /
#      CapturedLoop, and the same-module functions it calls by bare name,
#      with the parameters that receive its values — nothing pulls a value
#      to the host or branches or asserts on one: in a CUDA graph that is
#      an error at capture, and eagerly a sync point inside the loop.

_SYNC_ALLOWED = (SYNC_RELPATH, "chip_smoke.py", "scripts/")
_NP_SINKS = {"numpy.asarray", "numpy.array", "numpy.asanyarray"}
_PULL_METHODS = ("item", "cpu", "tolist", "numpy")
_CAPTURE_MAKERS = ("make_loop", "CapturedLoop", "make_call", "CapturedCall")


class _TaintChecker:
    """Flag host-sync sinks on values tainted by a captured body's
    parameters, following same-module calls by bare name."""

    # static reads of a tensor: metadata, no sync involved
    _STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda", "size",
                     "dim")
    _STATIC_CALLS = ("size", "dim")

    def __init__(self, mod: Module, findings: list):
        self.mod = mod
        self.findings = findings
        self.module_fns = {n.name: n for n in mod.tree.body
                           if isinstance(n, _FN)}
        self.done: set = set()

    def check(self, fn, tainted: set):
        key = (id(fn), frozenset(tainted))
        if key in self.done:
            return
        self.done.add(key)
        tainted = set(tainted)
        self._propagate(fn, tainted)
        self._sinks(fn, tainted)
        self._follow(fn, tainted)

    def _is_tainted(self, expr, tainted) -> bool:
        if isinstance(expr, ast.Attribute) \
                and expr.attr in self._STATIC_ATTRS:
            return False
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) and expr.func.id == "len":
                return False
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in self._STATIC_CALLS:
                return False
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False      # an identity test reads no value
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        return any(self._is_tainted(sub, tainted)
                   for sub in ast.iter_child_nodes(expr))

    def _flag(self, node, what):
        self.findings.append(self.mod.finding(
            "host-sync", node,
            f"{what} on a captured value inside a CUDA-graph loop body — "
            f"a host synchronization point in the loop (and an error at "
            f"capture)"))

    def _propagate(self, fn, tainted):
        grown = True
        while grown:
            n0 = len(tainted)
            for node in ast.walk(fn):
                value, targets = None, ()
                if isinstance(node, ast.Assign):
                    value, targets = node.value, node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                        and node.value is not None:
                    value, targets = node.value, (node.target,)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    value, targets = node.iter, (node.target,)
                elif isinstance(node, ast.NamedExpr):
                    value, targets = node.value, (node.target,)
                if value is not None and self._is_tainted(value, tainted):
                    for t in targets:
                        for sub in ast.walk(t):
                            if isinstance(sub, ast.Name):
                                tainted.add(sub.id)
            grown = len(tainted) > n0

    def _sinks(self, fn, tainted):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                rname = resolve(dotted_name(node.func), self.mod.aliases)
                if rname in _NP_SINKS:
                    if any(self._is_tainted(a, tainted) for a in node.args):
                        self._flag(node, rname)
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _PULL_METHODS \
                        and not node.args:
                    if self._is_tainted(node.func.value, tainted):
                        self._flag(node, f".{node.func.attr}()")
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in ("bool", "int", "float") \
                        and node.func.id not in tainted:
                    if any(self._is_tainted(a, tainted) for a in node.args):
                        self._flag(node, f"{node.func.id}()")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if self._is_tainted(node.test, tainted):
                    self._flag(node, "branching (implicit bool())")
            elif isinstance(node, ast.Assert):
                if self._is_tainted(node.test, tainted):
                    self._flag(node, "assert (implicit bool())")

    def _follow(self, fn, tainted):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            callee = self.module_fns.get(node.func.id)
            if callee is None or node.func.id in tainted:
                continue
            params = callee.args.posonlyargs + callee.args.args
            hit = {params[i].arg for i, a in enumerate(node.args)
                   if i < len(params) and not isinstance(a, ast.Starred)
                   and self._is_tainted(a, tainted)}
            names = {a.arg for a in params + callee.args.kwonlyargs}
            hit |= {kw.arg for kw in node.keywords
                    if kw.arg in names and self._is_tainted(kw.value,
                                                            tainted)}
            if hit:
                self.check(callee, hit)


def _captured_bodies(mod: Module) -> list:
    """(def, tainted params) of every first argument of make_loop /
    CapturedLoop that is a lambda or names a def of the calling frame or
    of the module."""
    out = []
    module_defs = [n for n in mod.tree.body if isinstance(n, _FN)]
    for _, _, nodes in _frames(mod):
        for node in nodes:
            if not (isinstance(node, ast.Call) and node.args
                    and _sync_short(node.func, mod) in _CAPTURE_MAKERS):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Lambda):
                out.append((arg, {a.arg for a in arg.args.args}))
                continue
            if not isinstance(arg, ast.Name):
                continue
            local = [n for n in nodes if isinstance(n, _FN)]
            for fn in [n for n in local + module_defs
                       if n.name == arg.id][:1]:
                params = (fn.args.posonlyargs + fn.args.args
                          + fn.args.kwonlyargs)
                out.append((fn, {a.arg for a in params
                                 if a.arg != "self"}))
    return out


@register_rule("host-sync")
def check_host_sync(mod: Module) -> list:
    """.synchronize() only in core/sync.py (fence), chip_smoke.py and
    scripts/; no host pull inside a captured loop body"""
    findings: list = []
    # 1. .synchronize() outside the sanctioned sync sites
    if not _allowed(mod.relpath, _SYNC_ALLOWED):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr == "synchronize":
                findings.append(mod.finding(
                    "host-sync", node,
                    "synchronize outside core/sync.py, chip_smoke.py and "
                    "scripts/ — route the sync through core.sync.fence so "
                    "sync points stay auditable"))
    # 2. host pulls inside captured bodies
    checker = _TaintChecker(mod, findings)
    for fn, tainted in _captured_bodies(mod):
        if isinstance(fn, ast.Lambda):
            checker._sinks(fn, set(tainted))
        else:
            checker.check(fn, tainted)
    return _dedupe(findings)


# ====================================================== use-after-replay ====
#
# A loop's outputs are its graph's static buffers: the next replay of it
# overwrites them in place. So a value bound from a loop call is copied
# (.clone(), .cpu(), .tolist(), .numpy(), .item(), torch.cat / stack)
# before it is returned, stored on an attribute or in a container, or read
# after any later loop call in the same function; passing it back as the
# next call's input is fine (the call copies it into its input buffers
# first). CPU runs mask these bugs (a loop is its eager body there) — which
# is exactly why a static rule, not a test, has to hold the line.
#
# Second check: a paged pool-carrying function keeps its pool's tensors —
# the ``pool`` parameter is never rebound (but from another pool-carrying
# call that is given it), ``pool[k] = ...`` never swaps a leaf, and a
# returned pool is the parameter itself. Graphs are captured over the
# pool's tensors: a new tensor would leave them writing stale storage.

_COPY_METHODS = {"clone", "cpu", "tolist", "numpy", "item"}
_COPY_FUNCS = {"torch.cat", "torch.stack", "torch.concat",
               "torch.concatenate"}
# methods that may return the receiver's storage (a view, or itself)
_VIEW_METHODS = {
    "view", "view_as", "reshape", "reshape_as", "detach", "expand",
    "expand_as", "narrow", "squeeze", "unsqueeze", "transpose", "permute",
    "t", "flatten", "unflatten", "contiguous", "to", "type", "type_as",
    "float", "half", "bfloat16", "double", "long", "int", "bool", "short",
    "char", "byte", "cuda", "as_strided", "select", "split", "chunk",
    "unbind", "movedim", "swapaxes", "diagonal", "unfold", "values",
    "items", "get",
}
_PASS_THROUGH = {"dict", "list", "tuple"}
_STORE_METHODS = {"append", "extend", "insert", "add", "setdefault",
                  "update"}
_METADATA = ("shape", "dtype", "device", "ndim", "is_cuda")

POOL_CARRYING = {"paged_prefill", "paged_decode_step", "paged_verify",
                 "mixed_step", "_cow_copy", "_run_layers_paged"}


def _terminates(stmts: list) -> bool:
    """True if the block's last statement unconditionally leaves it."""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))


@dataclass
class _Out:
    callee: str
    line: int           # the loop call that bound it
    stale: int = 0      # the later loop call that overwrote it, 0 if none


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if k not in out or (v.stale and not out[k].stale):
            out[k] = v
    return out


class _ReplayWalker:
    """Walk one function linearly, tracking the values bound from loop
    calls (the reference's _DonateWalker: branch merging, two passes over
    loop bodies)."""

    def __init__(self, mod: Module, lb: LoopBindings, fn, cls,
                 findings: list):
        self.mod, self.lb, self.fn, self.cls = mod, lb, fn, cls
        self.findings = findings
        self.forwarder = fn.name in REPLAY_FORWARDERS
        self.live: dict[str, _Out] = {}

    def _flag(self, node, message):
        self.findings.append(self.mod.finding("use-after-replay", node,
                                              message))

    # ------------------------------------------------------------- values --
    def _lookup(self, d: str) -> Optional[_Out]:
        return self._entry(d)[1]

    def _entry(self, d: str) -> tuple:
        """(the tracked name ``d`` reads, its output) or (None, None)."""
        for name, out in self.live.items():
            if d == name or d.startswith(name + "."):
                return name, out
        return None, None

    def exposes(self, expr) -> Optional[_Out]:
        """The loop output ``expr``'s value shares storage with, if any."""
        if isinstance(expr, (ast.Name, ast.Attribute)):
            if isinstance(expr, ast.Attribute) and expr.attr in _METADATA:
                return None
            d = dotted_name(expr)
            return self._lookup(d) if d else None
        if isinstance(expr, (ast.Subscript, ast.Starred, ast.NamedExpr,
                             ast.Await)):
            return self.exposes(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return self._first(expr.elts)
        if isinstance(expr, ast.Dict):
            return self._first(expr.values)
        if isinstance(expr, ast.IfExp):
            return self._first([expr.body, expr.orelse])
        if isinstance(expr, ast.BoolOp):
            return self._first(expr.values)
        if isinstance(expr, ast.Call):
            callee = self.lb.loop_call(expr, self.fn, self.cls)
            if callee is not None:
                return _Out(callee, expr.lineno)
            func = expr.func
            if isinstance(func, ast.Attribute):
                if func.attr in _COPY_METHODS:
                    return None
                if func.attr in _VIEW_METHODS or (
                        func.attr.endswith("_")
                        and not func.attr.startswith("_")):
                    return self.exposes(func.value)
            name = resolve(dotted_name(func), self.mod.aliases)
            if name in _COPY_FUNCS:
                return None
            if name in _PASS_THROUGH or _sync_short(func, self.mod) \
                    == "fence":
                return self._first(list(expr.args)
                                   + [k.value for k in expr.keywords])
        return None

    def _first(self, exprs) -> Optional[_Out]:
        for e in exprs:
            if e is not None:
                out = self.exposes(e)
                if out is not None:
                    return out
        return None

    # ------------------------------------------------------------- events --
    def read(self, d: str, node):
        name, out = self._entry(d)
        if out is not None and out.stale:
            self._flag(node, f"{name} is read after the loop call at line "
                       f"{out.stale} replayed over it (bound from "
                       f"{out.callee} at line {out.line}) — copy it "
                       f"(.clone()) before the next call")

    def store(self, d: str):
        for name in list(self.live):
            if name == d or name.startswith(d + "."):
                del self.live[name]

    def eval_expr(self, node):
        """Reads first, then the loop calls the expression makes."""
        if node is None:
            return
        inner: set = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute):
                v = sub.value
                while isinstance(v, ast.Attribute):
                    inner.add(id(v))
                    v = v.value
                if isinstance(v, ast.Name):
                    inner.add(id(v))
            elif isinstance(sub, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops):
                # an identity test reads no storage
                inner.update(id(e) for e in [sub.left, *sub.comparators])
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Name, ast.Attribute)) \
                    and id(sub) not in inner \
                    and isinstance(getattr(sub, "ctx", None), ast.Load) \
                    and not (isinstance(sub, ast.Attribute)
                             and sub.attr in _METADATA):
                d = dotted_name(sub)
                if d:
                    self.read(d, sub)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and self.lb.loop_call(sub, self.fn, self.cls):
                # the outputs bound before the call are now overwritten
                self.live = {k: _Out(v.callee, v.line, v.stale or sub.lineno)
                             for k, v in self.live.items()}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._container_store(sub)

    def _container_store(self, call: ast.Call):
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in _STORE_METHODS:
            out = self._first(list(call.args)
                              + [k.value for k in call.keywords])
            if out is not None:
                self._flag(call, f"a loop output (from {out.callee} at "
                           f"line {out.line}) is stored in a container "
                           f"uncopied — the next replay overwrites it; "
                           f"store .clone()")

    def assign(self, target, value, out: Optional[_Out]):
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self.assign(t, v, self.exposes(v))
            else:
                for t in target.elts:
                    self.assign(t, None, out)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, None, out)
        elif isinstance(target, ast.Name):
            self.store(target.id)
            if out is not None:
                self.live[target.id] = out
        elif isinstance(target, ast.Attribute):
            d = dotted_name(target)
            if d:
                self.store(d)
            if out is not None:
                self._flag(target, f"a loop output (from {out.callee} at "
                           f"line {out.line}) is stored on an attribute "
                           f"uncopied — the next replay overwrites it; "
                           f"store .clone()")
        elif isinstance(target, ast.Subscript):
            d = dotted_name(target.value)
            if d:
                self.read(d, target)
            self.eval_expr(target.slice)
            if out is not None:
                self._flag(target, f"a loop output (from {out.callee} at "
                           f"line {out.line}) is stored in a container "
                           f"uncopied — the next replay overwrites it; "
                           f"store .clone()")

    # --------------------------------------------------------- statements --
    def exec_block(self, stmts):
        for s in stmts:
            self.exec_stmt(s)

    def exec_stmt(self, s):
        if isinstance(s, ast.Assign):
            out = self.exposes(s.value)
            self.eval_expr(s.value)
            for t in s.targets:
                self.assign(t, s.value, out)
        elif isinstance(s, ast.AugAssign):
            self.eval_expr(s.value)
            self.eval_expr(s.target)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                out = self.exposes(s.value)
                self.eval_expr(s.value)
                self.assign(s.target, s.value, out)
        elif isinstance(s, ast.Return):
            out = self.exposes(s.value) if s.value is not None else None
            self.eval_expr(s.value)
            if out is not None and not self.forwarder:
                self._flag(s, f"a loop output (from {out.callee} at line "
                           f"{out.line}) is returned uncopied — the next "
                           f"replay overwrites it under the caller; return "
                           f".clone()")
        elif isinstance(s, ast.Expr):
            self.eval_expr(s.value)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                d = dotted_name(t)
                if d:
                    self.store(d)
        elif isinstance(s, ast.If):
            self.eval_expr(s.test)
            before = dict(self.live)
            self.exec_block(s.body)
            after_body = self.live
            self.live = dict(before)
            self.exec_block(s.orelse)
            body_falls = not _terminates(s.body)
            else_falls = not s.orelse or not _terminates(s.orelse)
            if body_falls and else_falls:
                self.live = _merge(self.live, after_body)
            elif body_falls:
                self.live = after_body
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self.eval_expr(s.iter)
            self.assign(s.target, None, None)
            before = dict(self.live)
            # two passes: an output bound in iteration N and read in N+1
            # after that iteration's call replayed over it
            self.exec_block(s.body)
            self.exec_block(s.body)
            self.exec_block(s.orelse)
            self.live = _merge(before, self.live)
        elif isinstance(s, ast.While):
            self.eval_expr(s.test)
            before = dict(self.live)
            self.exec_block(s.body)
            self.eval_expr(s.test)
            self.exec_block(s.body)
            self.exec_block(s.orelse)
            self.live = _merge(before, self.live)
        elif isinstance(s, ast.Try):
            self.exec_block(s.body)
            for h in s.handlers:
                self.exec_block(h.body)
            self.exec_block(s.orelse)
            self.exec_block(s.finalbody)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.eval_expr(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, None, None)
            self.exec_block(s.body)
        elif isinstance(s, (*_FN, ast.ClassDef)):
            pass   # different frame; handled by its own walk
        else:
            for sub in ast.iter_child_nodes(s):
                if isinstance(sub, ast.expr):
                    self.eval_expr(sub)


def _pool_param(fn) -> bool:
    return any(a.arg == "pool" for a in fn.args.posonlyargs + fn.args.args
               + fn.args.kwonlyargs)


def _passes_pool(call: ast.Call) -> bool:
    """A call of a pool-carrying function given the ``pool`` parameter."""
    d = dotted_name(call.func)
    if d is None or d.rsplit(".", 1)[-1] not in POOL_CARRYING:
        return False
    return any(isinstance(a, ast.Name) and a.id == "pool"
               for a in list(call.args) + [k.value for k in call.keywords])


def _names_pool(expr) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "pool"
               for n in ast.walk(expr))


def _flat_targets(targets):
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            yield from _flat_targets(t.elts)
        elif isinstance(t, ast.Starred):
            yield from _flat_targets((t.value,))
        else:
            yield t


def _check_pool_carrier(mod: Module, fn, findings: list):
    def flag(node, message):
        findings.append(mod.finding("use-after-replay", node, message))

    for node in _own_nodes(fn):
        targets, value = (), None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.AsyncFor, ast.NamedExpr)):
            targets = (node.target,)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            targets = tuple(i.optional_vars for i in node.items
                            if i.optional_vars is not None)
        elif isinstance(node, ast.Delete):
            targets = node.targets
        elif isinstance(node, ast.Return) and node.value is not None:
            elts = node.value.elts if isinstance(node.value, ast.Tuple) \
                else [node.value]
            for e in elts:
                fresh = isinstance(e, (ast.Dict, ast.DictComp)) or (
                    isinstance(e, ast.Call) and not _passes_pool(e)
                    and (dotted_name(e.func) == "dict"
                         or (isinstance(e.func, ast.Attribute)
                             and e.func.attr == "copy")))
                if fresh and _names_pool(e):
                    flag(node, f"pool-carrying {fn.name}() returns a new "
                         f"pool — return the pool parameter itself, "
                         f"updated in place")
        for t in _flat_targets(targets):
            if isinstance(t, ast.Name) and t.id == "pool":
                if isinstance(value, ast.Call) and _passes_pool(value):
                    continue
                flag(node, f"the pool parameter of pool-carrying "
                     f"{fn.name}() is rebound — a graph captured over "
                     f"the caller's pool would write stale storage; "
                     f"update the pool in place")
            elif isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "pool" \
                    and not isinstance(node, ast.AugAssign):
                flag(node, f"pool[...] = in pool-carrying {fn.name}() "
                     f"sets a new tensor in the pool — a graph "
                     f"captured over the old one writes stale storage; "
                     f"write into the leaf in place")


@register_rule("use-after-replay")
def check_use_after_replay(mod: Module) -> list:
    """loop outputs copied before they escape or outlive a later replay;
    pool-carrying functions keep the pool's tensors"""
    findings: list = []
    lb = collect_loop_bindings(mod)
    for fn, cls, nodes in _frames(mod)[1:]:
        # nothing to track in a frame that calls no loop
        if any(isinstance(n, ast.Call) and lb.loop_call(n, fn, cls)
               for n in nodes):
            _ReplayWalker(mod, lb, fn, cls, findings).exec_block(fn.body)
        if fn.name in POOL_CARRYING and _pool_param(fn):
            _check_pool_carrier(mod, fn, findings)
    # one finding per line: a statement exposing two outputs is one fault
    seen, out = set(), []
    for f in findings:
        if f.line not in seen:
            seen.add(f.line)
            out.append(f)
    return out

