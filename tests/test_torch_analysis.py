"""repolint-torch (repro_torch.analysis) against the reference's repolint
(repro.analysis): per-rule fixtures, pragma/baseline workflow, CLI exit
codes, parity with the reference on its own fixture trees, mirror pairs
(a JAX fixture and its torch twin), one-edit mutants of the live tree, and
the live-tree-clean self-check.

Fixture violations live in files written to tmp trees, never in this file
itself — both linters walk tests/ too.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import core as ref_core
from repro.analysis import schema as ref_schema
from repro_torch.analysis import core, schema
from repro_torch.analysis.core import (Baseline, load_module, parse_pragmas,
                                       run_repolint)
from repro_torch.analysis.schema import (SchemaConfig, StatsSource,
                                         check_schema_contract)

REPO = Path(__file__).resolve().parents[1]
AST_RULES = ("use-after-replay", "determinism", "capture-hygiene",
             "host-sync")
PORT_RULES = AST_RULES + ("schema-contract",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's smoke-size steps gain nothing from intra-op threads, and
    the suite's workers share the machine's cores: one thread each, the
    process's setting put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(tmp_path: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return tmp_path


def lint(tmp_path, files, rules=AST_RULES):
    return run_repolint(make_tree(tmp_path, files), rules=rules)


def rules_hit(report):
    return sorted({f.rule for f in report.findings})


def lines_of(report, rule=None):
    return {f.line for f in report.findings if rule in (None, f.rule)}


# ------------------------------------------------------------ determinism --

def test_determinism_true_positives(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/a.py": """\
        import time
        import random
        from time import sleep as zz
        import numpy as np
        import datetime
        import torch

        def f(x):
            t = time.time()
            zz(0.1)
            r = random.random()
            np.random.seed(0)
            d = datetime.datetime.now()
            torch.manual_seed(0)
            n = torch.randn(3)
            m = torch.multinomial(x, 1)
            y = torch.rand_like(x)
            torch.cuda.manual_seed_all(0)
            return t, r, d, n, m, y
    """}, rules=("determinism",))
    assert rules_hit(rep) == ["determinism"]
    assert lines_of(rep) == set(range(9, 19))
    assert len(rep.findings) == 10


def test_determinism_allowlists(tmp_path):
    rep = lint(tmp_path, {
        # telemetry.py IS the clock: monotonic allowed there, only there
        "src/repro_torch/serving/telemetry.py": """\
            import time
            def now():
                return time.monotonic()
        """,
        # chip_smoke.py and the port's scripts measure the card
        "scripts/bench_x.py": """\
            import time
            import repro_torch
            def bench():
                return time.perf_counter()
        """,
        "chip_smoke.py": """\
            import time
            def bench():
                return time.perf_counter()
        """,
        # seeded generators are the sanctioned RNGs
        "src/repro_torch/b.py": """\
            import numpy as np
            import torch
            def g():
                gen = torch.Generator().manual_seed(0)
                x = torch.randn(3, generator=gen)
                gen.manual_seed(1)
                x = x + torch.rand(3, generator=gen)
                return np.random.default_rng(0).normal(), x
        """,
    }, rules=("determinism",))
    assert rep.findings == []


def test_determinism_monotonic_banned_elsewhere(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/c.py": """\
        import time
        def f():
            return time.monotonic()
    """, "tests/test_c.py": """\
        import time
        import repro_torch
        def test_f():
            return time.perf_counter()
    """}, rules=("determinism",))
    assert {(f.path, f.line) for f in rep.findings} == {
        ("src/repro_torch/c.py", 3), ("tests/test_c.py", 4)}


def test_determinism_walk_covers_the_port_only(tmp_path):
    """src/repro is the reference linter's; tests/ and scripts/ files are
    walked only where their imports name repro_torch."""
    bad = "import time\nT = time.time()\n"
    rep = lint(tmp_path, {"src/repro/x.py": bad, "tests/test_x.py": bad,
                          "scripts/x.py": bad,
                          "tests/test_y.py": "import repro_torch.core\n"
                                             + bad,
                          "src/repro_torch/x.py": bad},
               rules=("determinism",))
    assert {f.path for f in rep.findings} == {"src/repro_torch/x.py",
                                              "tests/test_y.py"}
    assert rep.n_files == 2


# ------------------------------------------------------- use-after-replay --

def test_use_after_replay_true_positive(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/d.py": """\
        from repro_torch.core.sync import make_loop

        class Sched:
            def __init__(self, fn, inputs):
                self._decode = make_loop(fn, inputs)

            def step(self, x, y):
                a = self._decode(x)
                b = self._decode(y)
                return a.sum(), b.clone()   # a read after b's replay
    """}, rules=("use-after-replay",))
    assert len(rep.findings) == 1
    f = rep.findings[0]
    assert f.rule == "use-after-replay" and f.line == 10
    assert "a is read after the loop call at line 9" in f.message


def test_use_after_replay_copy_is_clean(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/e.py": """\
        import torch
        from repro_torch.core.sync import make_loop

        class Sched:
            def __init__(self, fn, inputs):
                self._decode = make_loop(fn, inputs)

            def step(self, x, y):
                a = self._decode(x).clone()
                b, idx = self._decode(y)
                self.last = b.cpu()
                return a, torch.stack([b, b]), idx.tolist()
    """}, rules=("use-after-replay",))
    assert rep.findings == []


def test_use_after_replay_loop_carried(tmp_path):
    # bound in iteration N, read in iteration N+1 after that iteration's
    # call replayed over it — only visible on the second pass over the body
    rep = lint(tmp_path, {"src/repro_torch/f.py": """\
        from repro_torch.core.sync import make_loop

        step = make_loop(lambda c: c, INPUTS)

        def run(cache, n):
            deltas, prev = [], None
            for _ in range(n):
                cur = step(cache)
                if prev is not None:
                    deltas.append((cur - prev).abs().max().item())
                prev = cur
            return deltas
    """}, rules=("use-after-replay",))
    assert lines_of(rep) == {10}
    assert "prev is read after the loop call at line 8" \
        in rep.findings[0].message


def test_use_after_replay_branch_return_is_clean(tmp_path):
    # each branch copies what it returns; the fall-through path never saw
    # the first branch's replay (the core/sync.py window_replay shape)
    rep = lint(tmp_path, {"src/repro_torch/g.py": """\
        from repro_torch.core.sync import make_loop, window_replay

        def dispatch(win_loop, mixed_loop, pool, is_plain, extra):
            if is_plain:
                return win_loop(pool).clone()
            out, pre = window_replay(mixed_loop, (pool, extra), n_steps=1)
            return out.cpu().tolist(), pre.clone()
    """}, rules=("use-after-replay",))
    assert rep.findings == []


def test_use_after_replay_escapes(tmp_path):
    """Every way an uncopied output escapes: returned (also inside a dict
    or through a view), stored on an attribute or in a container."""
    rep = lint(tmp_path, {"src/repro_torch/h.py": """\
        from repro_torch.core.sync import make_loop, window_replay

        class Batcher:
            def __init__(self, body, inputs):
                self.loop = make_loop(body, inputs)

            def tick(self, x):
                toks, index = self.loop(x)
                self.last = index
                self.history.append(toks)
                self.cache["index"] = index
                return {"toks": toks[:, :1].view(-1)}

            def window(self, x):
                out = window_replay(self.loop, (x,), n_steps=4)
                return out
    """}, rules=("use-after-replay",))
    assert lines_of(rep) == {9, 10, 11, 12, 16}


def test_use_after_replay_pass_back_is_clean(tmp_path):
    # a host-synced loop feeding each replay's index into the next call
    # (core/sync.py's generate_host_loop)
    rep = lint(tmp_path, {"src/repro_torch/i.py": """\
        import torch

        def host_loop(loop, token, index, n):
            toks = []
            for _ in range(n):
                nxt, index = loop(token, index)
                token = nxt.cpu()
                toks.append(token[:, 0])
            return torch.stack(toks, dim=1), index.clone()
    """}, rules=("use-after-replay",))
    assert rep.findings == []


def test_use_after_replay_pool_carrier(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/models/m.py": """\
        def _run_layers_paged(params, x, *, pool):
            for t in pool.values():
                t[:, 0] = x
            pool["k"][1] = x
            return x, pool

        def paged_decode_step(params, token, pool):
            x, pool = _run_layers_paged(params, token, pool=pool)
            return x, pool

        def paged_prefill(params, tokens, pool):
            pool = {k: t.clone() for k, t in pool.items()}
            pool["v"] = tokens
            (pool,) = (tokens,)
            return tokens, {**pool}

        def decode_step(params, token, cache):
            cache = {**cache, "index": token}
            return token, cache
    """}, rules=("use-after-replay",))
    assert lines_of(rep) == {12, 13, 14, 15}


# -------------------------------------------------------- capture-hygiene --

def test_capture_hygiene_loop_and_hot_fn(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/h.py": """\
        from repro_torch.core.sync import make_loop

        def run(fns, x):
            for fn in fns:
                y = make_loop(fn, (x,))(x).clone()   # a capture per item
            return y

        class Engine:
            def step(self, x):
                return make_loop(self.fwd, (x,))(x).clone()   # per step
    """}, rules=("capture-hygiene",))
    assert len(rep.findings) == 2
    assert lines_of(rep) == {5, 10}


def test_capture_hygiene_factories_guards_and_tests_exempt(tmp_path):
    rep = lint(tmp_path, {
        "src/repro_torch/i.py": """\
            from repro_torch.core import sync

            def make_train_step(fn, inputs):
                return sync.make_loop(fn, inputs)   # built once: fine

            def build_serve_step(fn, inputs):
                return sync.CapturedLoop(fn, inputs)

            class Batcher:
                def step(self, key):
                    if key not in self._loops:      # once per key: fine
                        self._loops[key] = sync.paged_step_loop(
                            self.model, self.params, self.pool, 4, 8)
                    for k in self.keys:
                        if k not in self.loops:
                            self.loops[k] = sync.slot_decode_loop(
                                self.model, self.params, self.cache, k)
                    return self._loops[key]
        """,
        "tests/test_i.py": """\
            from repro_torch.core.sync import make_loop

            def test_decode_step():
                out = make_loop(lambda x: x, (1,))(1)
        """,
    }, rules=("capture-hygiene",))
    assert rep.findings == []


def test_capture_hygiene_host_data_argument(tmp_path):
    files = {"src/repro_torch/j.py": """\
        import numpy as np
        import torch
        from repro_torch.core.sync import make_loop, stage, window_replay

        def serve(body, inputs, tokens, device):
            loop = make_loop(body, inputs)
            a = loop(torch.tensor(tokens)).clone()
            b = loop(*stage(tokens, device=device)).clone()
            c = loop(torch.from_numpy(np.asarray(tokens)).pin_memory())
            d = window_replay(loop, (torch.as_tensor(tokens).cuda(),),
                              n_steps=2).clone()
            return a, b, c.clone(), d
    """}
    rep = lint(tmp_path, files, rules=("capture-hygiene",))
    assert lines_of(rep) == {7, 10}
    assert all("stage it" in f.message for f in rep.findings)


def test_capture_hygiene_host_data_outside_src_is_clean(tmp_path):
    # the same call under tests/: a staging cost, not a library fault
    rep = lint(tmp_path, {"tests/test_j2.py": """\
        import torch
        from repro_torch.core.sync import make_loop

        def test_serve(body, inputs, tokens):
            loop = make_loop(body, inputs)
            assert loop(torch.tensor(tokens)).clone() is not None
    """}, rules=("capture-hygiene",))
    assert rep.findings == []


def test_capture_hygiene_graph_capture_only_in_sync(tmp_path):
    capture = """\
        import torch
        from torch.cuda import make_graphed_callables

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            return graph, make_graphed_callables
    """
    rep = lint(tmp_path, {"src/repro_torch/k.py": capture,
                          "src/repro_torch/core/sync.py": capture},
               rules=("capture-hygiene",))
    assert {(f.path, f.line) for f in rep.findings} == {
        ("src/repro_torch/k.py", 5), ("src/repro_torch/k.py", 6),
        ("src/repro_torch/k.py", 8)}


# -------------------------------------------------------------- host-sync --

def test_host_sync_synchronize_placement(tmp_path):
    rep = lint(tmp_path, {
        "src/repro_torch/k.py": """\
            import torch
            def f(x, stream, event):
                torch.cuda.synchronize()
                stream.synchronize()
                event.synchronize()
        """,
        "src/repro_torch/core/sync.py": """\
            import torch
            def fence(x):
                torch.cuda.synchronize()   # the sanctioned site
        """,
        "scripts/bench_k.py": """\
            import torch
            import repro_torch
            def bench(x):
                torch.cuda.synchronize()
        """,
        "chip_smoke.py": """\
            import torch
            def bench(x):
                torch.cuda.current_stream().synchronize()
        """,
    }, rules=("host-sync",))
    assert {(f.path, f.line) for f in rep.findings} == {
        ("src/repro_torch/k.py", 3), ("src/repro_torch/k.py", 4),
        ("src/repro_torch/k.py", 5)}


def test_host_sync_captured_body_sinks(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/l.py": """\
        import numpy as np
        from repro_torch.core.sync import make_loop

        def build(inputs):
            def body(x, n):
                y = x + 1
                if y.sum() > 0:            # implicit bool() on the device
                    y = y * 2
                h = np.asarray(y)          # a host pull in the capture
                k = int(n)                 # and another
                return y.cpu(), y.tolist()
            return make_loop(body, inputs)
    """}, rules=("host-sync",))
    assert lines_of(rep) == {7, 9, 10, 11}
    assert len(rep.findings) == 5


def test_host_sync_shape_branching_is_static(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/m.py": """\
        import torch.nn.functional as F
        from repro_torch.core.sync import make_loop

        def pad(q, table):
            D = q.shape[-1]
            if D % 128:                    # static: fine
                q = F.pad(q, (0, 128 - D % 128))
            assert q.ndim == 2 and q.dim() == 2 and q.is_cuda
            if table is None or q.size(0) != len(table):
                q = q.float()
            return q

        LOOP = make_loop(pad, INPUTS)
    """}, rules=("host-sync",))
    assert rep.findings == []


def test_host_sync_callee_checked(tmp_path):
    # a same-module function the body calls by bare name is checked with
    # the parameters that receive the body's values; the others are not
    rep = lint(tmp_path, {"src/repro_torch/n.py": """\
        from repro_torch.core.sync import make_loop

        def helper(tokens, eos_id):
            if eos_id is not None and int(eos_id) > 0:
                tokens = tokens + 1
            if tokens.max() > 5:           # tokens come from the body
                tokens = tokens - 1
            return tokens

        def run(xs, eos_id):
            def body(x):
                return helper(x, eos_id)
            return make_loop(body, (xs,))
    """}, rules=("host-sync",))
    assert lines_of(rep) == {6}


# -------------------------------------------------------- schema-contract --

_SCHEMA_CFG = SchemaConfig(
    trace_relpath="src/pkg/trace.py",
    docs_relpath="docs/obs.md",
    sources=(StatsSource("src/pkg/sched.py", "B", "stats", "b",
                         merged=False),),
    snapshot_keys=(),
    emission_prefixes=("src/pkg/",))

_SCHEMA_TRACE = """\
    STATS_COUNTER_KEYS = ("hits",)
    STATS_GAUGE_KEYS = ("depth",)
"""
_SCHEMA_SCHED = """\
    class B:
        def stats(self):
            return {"hits": self.hits, "depth": self.d}

        def tick(self):
            self.tracer.count("hits")
            self.tracer.gauge("depth", 1)
"""
_SCHEMA_DOCS = """\
    ## Metrics exposition

    - counters: `hits`; plus `dispatches{kind=...}`.
    - gauges: `depth`.
"""
_SCHEMA_POOL = """\
    class P:
        def pool_stats(self):
            return {"hits": 0}     # collides with B.stats
"""


def _modules(root: Path, loader=load_module):
    return [m for m in (loader(p, root)
                        for p in sorted(root.rglob("*.py"))) if m]


def _schema_findings(tmp_path, files, cfg=_SCHEMA_CFG):
    root = make_tree(tmp_path, files)
    return check_schema_contract(root, _modules(root), config=cfg)


def test_schema_contract_consistent_tree_is_clean(tmp_path):
    assert _schema_findings(tmp_path, {
        "src/pkg/trace.py": _SCHEMA_TRACE,
        "src/pkg/sched.py": _SCHEMA_SCHED,
        "docs/obs.md": _SCHEMA_DOCS}) == []


def test_schema_contract_catches_unregistered_counter(tmp_path):
    sched = _SCHEMA_SCHED.replace(
        'self.tracer.count("hits")',
        'self.tracer.count("hits")\n'
        '            self.tracer.count("misses")')
    found = _schema_findings(tmp_path, {
        "src/pkg/trace.py": _SCHEMA_TRACE,
        "src/pkg/sched.py": sched,
        "docs/obs.md": _SCHEMA_DOCS})
    assert any("misses" in f.message and "STATS_COUNTER_KEYS" in f.message
               for f in found)


def test_schema_contract_catches_stats_key_without_producer(tmp_path):
    trace = _SCHEMA_TRACE.replace('("hits",)', '("hits", "orphan")')
    found = _schema_findings(tmp_path, {
        "src/pkg/trace.py": trace,
        "src/pkg/sched.py": _SCHEMA_SCHED,
        "docs/obs.md": _SCHEMA_DOCS})
    msgs = "\n".join(f.message for f in found)
    assert "orphan" in msgs and "stats()" in msgs


def test_schema_contract_catches_docs_drift(tmp_path):
    docs = _SCHEMA_DOCS.replace("`hits`; plus", "`stale_name`; plus")
    found = _schema_findings(tmp_path, {
        "src/pkg/trace.py": _SCHEMA_TRACE,
        "src/pkg/sched.py": _SCHEMA_SCHED,
        "docs/obs.md": docs})
    msgs = "\n".join(f.message for f in found)
    assert "hits" in msgs and "stale_name" in msgs


def test_schema_contract_collision_between_merged_groups(tmp_path):
    cfg = SchemaConfig(
        trace_relpath="src/pkg/trace.py", docs_relpath="docs/obs.md",
        sources=(StatsSource("src/pkg/sched.py", "B", "stats", "b",
                             merged=True),
                 StatsSource("src/pkg/pool.py", "P", "pool_stats", "p",
                             merged=True)),
        snapshot_keys=(), emission_prefixes=("src/pkg/",))
    found = _schema_findings(tmp_path, {
        "src/pkg/trace.py": _SCHEMA_TRACE,
        "src/pkg/sched.py": _SCHEMA_SCHED,
        "src/pkg/pool.py": _SCHEMA_POOL,
        "docs/obs.md": _SCHEMA_DOCS}, cfg)
    assert any("collides" in f.message for f in found)


def test_schema_contract_emissions_only_from_the_port(tmp_path):
    """A call site outside emission_prefixes does not count; the port's
    traced_dispatch kinds do."""
    files = {
        "src/pkg/trace.py": _SCHEMA_TRACE,
        "src/pkg/sched.py": _SCHEMA_SCHED.replace(
            '            self.tracer.count("hits")\n', ''),
        "src/other/sched.py": _SCHEMA_SCHED,
        "src/pkg/spec.py": """\
            from repro_torch.core.sync import traced_dispatch
            def draft(self):
                with traced_dispatch(self.tracer, "spec_draft", self.k):
                    pass
        """,
        "docs/obs.md": textwrap.dedent(_SCHEMA_DOCS) + textwrap.dedent("""\

            **Dispatch spans**

            | name | emitted by | meaning |
            |---|---|---|
            | `spec_draft` | draft lanes | draft work |
        """)}
    found = _schema_findings(tmp_path, files)
    assert [f.message for f in found] == [
        "STATS counter 'hits' has no literal tracer.count() site — the "
        "metrics ledger can never move for it"]


# --------------------------------------------------------- pragma workflow --

def test_pragma_suppresses_with_reason(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/p.py": """\
        import time
        def f():
            return time.time()  # repolint-torch: disable=determinism -- fixture
    """}, rules=("determinism",))
    assert rep.findings == [] and rep.suppressed == 1


def test_pragma_without_reason_is_a_finding(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/q.py": """\
        import time
        def f():
            return time.time()  # repolint-torch: disable=determinism
    """}, rules=("determinism",))
    # suppression still applies, but the bare pragma itself is flagged
    assert rep.suppressed == 1
    assert [f.rule for f in rep.findings] == ["pragma"]
    assert "no reason" in rep.findings[0].message


def test_unused_and_unknown_pragmas_are_findings(tmp_path):
    rep = lint(tmp_path, {"src/repro_torch/r.py": """\
        x = 1  # repolint-torch: disable=determinism -- suppresses nothing
        y = 2  # repolint-torch: disable=jit-hygiene -- the reference's rule
    """}, rules=("determinism",))
    msgs = sorted(f.message for f in rep.findings)
    assert len(msgs) == 2
    assert any("unused pragma" in m for m in msgs)
    assert any("unknown rule 'jit-hygiene'" in m for m in msgs)


def test_reference_marker_honoured_for_determinism_only(tmp_path):
    """The reference's '# repolint:' marker suppresses determinism (the
    rule both linters share) and nothing else, and is never reported: it
    is the reference linter's to police."""
    rep = lint(tmp_path, {"src/repro_torch/s.py": """\
        import time
        import torch
        def f():
            t = time.time()  # repolint: disable=determinism -- fixture
            torch.cuda.synchronize()  # repolint: disable=host-sync -- no
            x = 1  # repolint: disable=no-such-rule -- not ours to flag
            y = 2  # repolint: disable=determinism
            return t
    """}, rules=("determinism", "host-sync"))
    assert rep.suppressed == 1
    assert [(f.rule, f.line) for f in rep.findings] == [("host-sync", 5)]


def test_pragma_parser():
    pragmas = parse_pragmas([
        "x = 1  # repolint-torch: disable=determinism,host-sync -- two",
        "y = 2  # repolint: disable=determinism -- the reference's",
        "z = 3",
    ])
    assert list(pragmas) == [1]
    assert pragmas[1].rules == ("determinism", "host-sync")
    assert pragmas[1].reason == "two"
    ref = parse_pragmas(["y = 2  # repolint: disable=determinism -- r"],
                        core.REFERENCE_MARKER)
    assert ref[1].rules == ("determinism",) and ref[1].reason == "r"


# ------------------------------------------------------- baseline workflow --

def test_baseline_round_trip(tmp_path):
    files = {"src/repro_torch/s.py": """\
        import time
        def f():
            return time.time()
    """}
    root = make_tree(tmp_path, files)
    rep = run_repolint(root, rules=("determinism",))
    assert len(rep.new) == 1

    bpath = root / "baseline.json"
    Baseline.from_findings(rep.findings).save(bpath)
    rep2 = run_repolint(root, rules=("determinism",),
                        baseline=Baseline.load(bpath))
    assert rep2.ok and rep2.new == [] and rep2.stale == []

    # fingerprints are line-number independent: edits above don't churn
    (root / "src/repro_torch/s.py").write_text(
        "import time\n\n\ndef f():\n    return time.time()\n")
    rep3 = run_repolint(root, rules=("determinism",),
                        baseline=Baseline.load(bpath))
    assert rep3.ok

    # fixing the finding makes the baseline entry stale -> not ok
    (root / "src/repro_torch/s.py").write_text("def f():\n    return 0\n")
    rep4 = run_repolint(root, rules=("determinism",),
                        baseline=Baseline.load(bpath))
    assert not rep4.ok and len(rep4.stale) == 1


# ------------------------------------------------------------------- CLI ---

def _cli(*args, script="repolint_torch.py"):
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / script), *args],
        capture_output=True, text=True)


def test_cli_exit_codes(tmp_path):
    root = make_tree(tmp_path, {"src/repro_torch/t.py":
                                "def f():\n    return 0\n"})
    clean = _cli("--root", str(root), "--rules", "determinism", "--check")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "[repolint-torch] 1 files, 0 findings" in clean.stdout

    (root / "src/repro_torch/t.py").write_text(
        "import time\nT = time.time()\n")
    dirty = _cli("--root", str(root), "--rules", "determinism", "--check")
    assert dirty.returncode == 1
    assert "[determinism]" in dirty.stdout and "FAIL" in dirty.stdout

    bpath = tmp_path / "b.json"
    upd = _cli("--root", str(root), "--rules", "determinism",
               "--baseline", str(bpath), "--update-baseline")
    assert upd.returncode == 0 and "wrote 1 fingerprint" in upd.stdout
    again = _cli("--root", str(root), "--rules", "determinism",
                 "--baseline", str(bpath), "--check")
    assert again.returncode == 0, again.stdout


def test_cli_list_rules():
    out = _cli("--list-rules")
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines()]
    assert sorted(listed) == sorted(PORT_RULES + ("pragma",))


def test_analysis_imports_no_jax_and_no_reference():
    """The analysis modules and the CLI import the standard library and
    each other only; the CLI runs without importing torch."""
    import ast
    stdlib = set(sys.stdlib_module_names)
    for path in [*(REPO / "src/repro_torch/analysis").glob("*.py"),
                 REPO / "scripts/repolint_torch.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in stdlib | {"__future__"}, \
                    (path.name, name)
    probe = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         f"runpy.run_path({str(REPO / 'scripts/repolint_torch.py')!r})\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0]"
         " in ('torch', 'jax', 'repro', 'repro_torch')))"],
        capture_output=True, text=True)
    assert probe.returncode == 0, probe.stderr
    assert probe.stdout.strip() == "[]"


# ----------------------------------------------- parity with the reference --
#
# The reference's own fixture trees (tests/test_analysis.py), each file
# moved into the port's walk: src/repro/... and src/... under
# src/repro_torch/, benchmarks/ under scripts/ (given an import of the
# port on an added last line, so line numbers stay), the pragma marker
# made the port's. determinism and schema-contract must then give the same
# (path, line, rule) findings as the reference's on the original tree.

_REF_DETERMINISM_TREES = {
    "true_positives": {"src/a.py": """\
        import time
        import random
        from time import sleep as zz
        import numpy as np
        import datetime

        def f():
            t = time.time()
            zz(0.1)
            r = random.random()
            np.random.seed(0)
            d = datetime.datetime.now()
            return t, r, d
    """},
    "allowlists": {
        "src/repro/serving/telemetry.py": """\
            import time
            def now():
                return time.monotonic()
        """,
        "benchmarks/bench_x.py": """\
            import time
            def bench():
                return time.perf_counter()
        """,
        "src/b.py": """\
            import numpy as np
            def g():
                return np.random.default_rng(0).normal()
        """,
    },
    "monotonic_banned_elsewhere": {"src/c.py": """\
        import time
        def f():
            return time.monotonic()
    """},
    "benchmark_sleep": {"benchmarks/bench_y.py": """\
        import time
        def bench():
            time.sleep(0.1)
            return time.perf_counter()
    """},
    "pragma_with_reason": {"src/p.py": """\
        import time
        def f():
            return time.time()  # repolint: disable=determinism -- fixture
    """},
    "pragma_without_reason": {"src/q.py": """\
        import time
        def f():
            return time.time()  # repolint: disable=determinism
    """},
    "unused_and_unknown_pragmas": {"src/r.py": """\
        x = 1  # repolint: disable=determinism -- suppresses nothing
        y = 2  # repolint: disable=no-such-rule -- typo'd rule name
    """},
}


def _to_port(rel: str) -> str:
    if rel.startswith("src/repro/"):
        return "src/repro_torch/" + rel[len("src/repro/"):]
    if rel.startswith("src/"):
        return "src/repro_torch/" + rel[len("src/"):]
    if rel.startswith("benchmarks/"):
        return "scripts/" + rel[len("benchmarks/"):]
    return rel


def _port_tree(files: dict) -> dict:
    out = {}
    for rel, text in files.items():
        text = textwrap.dedent(text).replace("# repolint:",
                                             "# repolint-torch:")
        if rel.startswith("benchmarks/"):
            text += "import repro_torch\n"
        out[_to_port(rel)] = text
    return out


@pytest.mark.parametrize("name", sorted(_REF_DETERMINISM_TREES))
def test_parity_determinism_on_reference_fixtures(tmp_path, name):
    files = _REF_DETERMINISM_TREES[name]
    ref_root = make_tree(tmp_path / "ref", files)
    port_root = make_tree(tmp_path / "port", _port_tree(files))
    ref = ref_core.run_repolint(ref_root, rules=("determinism",))
    port = run_repolint(port_root, rules=("determinism",))
    assert {(_to_port(f.path), f.line, f.rule) for f in ref.findings} \
        == {(f.path, f.line, f.rule) for f in port.findings}
    assert ref.suppressed == port.suppressed
    assert ref.ok == port.ok


def _ref_schema_config(cfg: SchemaConfig):
    return ref_schema.SchemaConfig(
        trace_relpath=cfg.trace_relpath, docs_relpath=cfg.docs_relpath,
        extra_counters=cfg.extra_counters,
        sources=tuple(ref_schema.StatsSource(s.relpath, s.cls, s.func,
                                             s.label, s.merged)
                      for s in cfg.sources),
        snapshot_keys=cfg.snapshot_keys)


_MERGED_CFG = SchemaConfig(
    trace_relpath="src/pkg/trace.py", docs_relpath="docs/obs.md",
    sources=(StatsSource("src/pkg/sched.py", "B", "stats", "b", merged=True),
             StatsSource("src/pkg/pool.py", "P", "pool_stats", "p",
                         merged=True)),
    snapshot_keys=(), emission_prefixes=("src/pkg/",))
_BASE = {"src/pkg/trace.py": _SCHEMA_TRACE, "src/pkg/sched.py": _SCHEMA_SCHED,
         "docs/obs.md": _SCHEMA_DOCS}
_REF_SCHEMA_TREES = {
    "consistent": (_BASE, _SCHEMA_CFG),
    "unregistered_counter": ({**_BASE, "src/pkg/sched.py":
                              _SCHEMA_SCHED.replace(
                                  'self.tracer.count("hits")',
                                  'self.tracer.count("hits")\n'
                                  '            self.tracer.count("misses")')},
                             _SCHEMA_CFG),
    "stats_key_without_producer": ({**_BASE, "src/pkg/trace.py":
                                    _SCHEMA_TRACE.replace(
                                        '("hits",)', '("hits", "orphan")')},
                                   _SCHEMA_CFG),
    "docs_drift": ({**_BASE, "docs/obs.md": _SCHEMA_DOCS.replace(
        "`hits`; plus", "`stale_name`; plus")}, _SCHEMA_CFG),
    "merged_collision": ({**_BASE, "src/pkg/pool.py": _SCHEMA_POOL},
                         _MERGED_CFG),
    "missing_source": ({k: v for k, v in _BASE.items()
                        if k != "src/pkg/sched.py"}, _SCHEMA_CFG),
}


@pytest.mark.parametrize("name", sorted(_REF_SCHEMA_TREES))
def test_parity_schema_contract_on_reference_fixtures(tmp_path, name):
    files, cfg = _REF_SCHEMA_TREES[name]
    root = make_tree(tmp_path, files)
    ref = ref_schema.check_schema_contract(
        root, _modules(root, ref_core.load_module),
        config=_ref_schema_config(cfg))
    port = check_schema_contract(root, _modules(root), config=cfg)
    assert [(f.path, f.line, f.rule) for f in ref] \
        == [(f.path, f.line, f.rule) for f in port]
    assert (name == "consistent") == (port == [])


def test_parity_pragma_parser_and_baseline_split():
    lines = ["a = 1  # {m}: disable=determinism,host-sync -- two rules",
             "b = 2  # {m}: disable=determinism",
             "c = 3",
             "d = '# {m}: disable=determinism -- in a string'",
             "e = 4  #{m}:disable= x , y --   spaced reason  "]
    ref = ref_core.parse_pragmas([s.format(m="repolint") for s in lines])
    port = parse_pragmas([s.format(m="repolint-torch") for s in lines])
    assert {k: (p.rules, p.reason) for k, p in ref.items()} \
        == {k: (p.rules, p.reason) for k, p in port.items()}
    assert sorted(port) == [1, 2, 5]

    def findings(make):
        return [make(rule="determinism", path="src/x.py", line=n,
                     message="m", snippet=s)
                for n, s in ((1, "a"), (2, "a"), (3, "b"), (9, "c"))]
    ref_base = ref_core.Baseline.from_findings(findings(ref_core.Finding)[:3])
    port_base = Baseline.from_findings(findings(core.Finding)[:3])
    ref_base.counts["src/x.py::determinism::gone"] += 1
    port_base.counts["src/x.py::determinism::gone"] += 1
    ref_new, ref_stale = ref_base.split(findings(ref_core.Finding)[1:])
    port_new, port_stale = port_base.split(findings(core.Finding)[1:])
    assert [f.fingerprint for f in ref_new] \
        == [f.fingerprint for f in port_new] == ["src/x.py::determinism::c"]
    assert ref_stale == port_stale == ["src/x.py::determinism::a",
                                       "src/x.py::determinism::gone"]


@pytest.mark.parametrize("text, code", [
    ("def f():\n    return 0\n", 0),
    ("import time\nT = time.time()\n", 1),
    ("import time\nT = time.time()  # {m}: disable=determinism -- r\n", 0),
    ("X = 1  # {m}: disable=determinism -- suppresses nothing\n", 1),
])
def test_parity_cli_exit_codes(tmp_path, text, code):
    """Both CLIs on one tree (the port's file lies under src/, which the
    reference walks too), each pragma in its own linter's marker."""
    got = {}
    for script, marker in (("repolint.py", "repolint"),
                           ("repolint_torch.py", "repolint-torch")):
        root = make_tree(tmp_path / marker, {
            "src/repro_torch/t.py": text.format(m=marker)})
        got[script] = _cli("--root", str(root), "--rules", "determinism",
                           "--check", script=script).returncode
    assert got == {"repolint.py": code, "repolint_torch.py": code}


# ------------------------------------------------------------ mirror pairs --
#
# A JAX fixture under the reference's rule and its torch twin under the
# port's: their findings fall on the same lines (empty for a clean pair).

_MIRRORS = {
    "read_after_donate_vs_returned_output": (
        "use-after-donate", """\
        import jax

        class Sched:
            def __init__(self, fn):
                self._decode = jax.jit(fn, donate_argnums=(1,))

            def step(self, params):
                logits, new_pool = self._decode(params, self.pool)
                return logits, self.pool.shape   # read of donated buffer
        """, "use-after-replay", """\
        from repro_torch.core.sync import make_loop

        class Sched:
            def __init__(self, fn, inputs):
                self._decode = make_loop(fn, inputs)

            def step(self, params):
                logits, new_pool = self._decode(params, self.pool)
                return logits, self.pool.shape   # the replay's own buffer
        """, {9}),
    "rebind_vs_copy_clean": (
        "use-after-donate", """\
        import jax

        class Sched:
            def __init__(self, fn):
                self._decode = jax.jit(fn, donate_argnums=(1,))

            def step(self, params):
                logits, self.pool = self._decode(params, self.pool)
                return logits, self.pool         # rebound: fine
        """, "use-after-replay", """\
        from repro_torch.core.sync import make_loop

        class Sched:
            def __init__(self, fn, inputs):
                self._decode = make_loop(fn, inputs)

            def step(self, params):
                logits, pool = self._decode(params, self.pool)
                return logits.clone(), pool.clone()   # copied: fine
        """, set()),
    "loop_carried": (
        "use-after-donate", """\
        import jax

        step = jax.jit(lambda c: c, donate_argnums=(0,))


        def run(cache, n):
            out = []
            for _ in range(n):
                out.append(step(cache))   # cache never rebound
            return out
        """, "use-after-replay", """\
        from repro_torch.core.sync import make_loop

        step = make_loop(lambda c: c, INPUTS)


        def run(cache, n):
            out = []
            for _ in range(n):
                out.append(step(cache))   # each output replayed over
            return out
        """, {9}),
    "branch_return_clean": (
        "use-after-donate", """\
        import jax

        win = jax.jit(lambda p: p, donate_argnums=(0,))
        mixed = jax.jit(lambda p, q: p, donate_argnums=(0,))

        def dispatch(pool, is_plain, extra):
            if is_plain:
                return win(pool)
            return mixed(pool, extra)
        """, "use-after-replay", """\
        from repro_torch.core.sync import make_loop

        win = make_loop(lambda p: p, INPUTS)
        mixed = make_loop(lambda p, q: p, INPUTS)

        def dispatch(pool, is_plain, extra):
            if is_plain:
                return win(pool).clone()
            return mixed(pool, extra).clone()
        """, set()),
    "built_in_loop_and_hot_fn": (
        "jit-hygiene", """\
        import jax

        def run(fns, x):
            for fn in fns:
                y = jax.jit(fn)(x)       # fresh wrapper every iteration
            return y

        class Engine:
            def step(self, x):
                return jax.jit(self.fwd)(x)   # re-jit per step
        """, "capture-hygiene", """\
        from repro_torch.core.sync import make_loop

        def run(fns, x):
            for fn in fns:
                y = make_loop(fn, (x,))(x).clone()   # a graph per item
            return y

        class Engine:
            def step(self, x):
                return make_loop(self.fwd, (x,))(x).clone()   # per step
        """, {5, 10}),
    "factories_clean": (
        "jit-hygiene", """\
        import jax

        def make_train_step(fn):
            return jax.jit(fn, donate_argnums=(0,))   # built once: fine

        def build_serve_step(fn):
            return jax.jit(fn)
        """, "capture-hygiene", """\
        from repro_torch.core.sync import make_loop

        def make_train_step(fn, inputs):
            return make_loop(fn, inputs)   # built once: fine

        def build_serve_step(fn, inputs):
            return make_loop(fn, inputs)
        """, set()),
    "library_only_check": (
        "jit-hygiene", """\
        import jax

        def paged_decode_step(params, tok, pool):
            return tok, pool

        f = jax.jit(paged_decode_step)
        """, "capture-hygiene", """\
        import torch
        from repro_torch.core.sync import make_loop

        def serve(body, inputs, tokens):
            loop = make_loop(body, inputs)
            return loop(torch.tensor(tokens)).clone()
        """, {6}),
    "sync_outside_sanctioned_site": (
        "host-sync", """\
        import jax
        def f(x):
            jax.block_until_ready(x)
        """, "host-sync", """\
        import torch
        def f(x):
            torch.cuda.synchronize()
        """, {3}),
    "traced_vs_captured_body_sinks": (
        "host-sync", """\
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            y = x + 1
            if y > 0:              # implicit bool() on traced value
                return y
            n = np.asarray(y)      # host pull inside the trace
            return y.item()        # and another
        """, "host-sync", """\
        import numpy as np
        from repro_torch.core.sync import make_loop


        def f(x):
            y = x + 1
            if y > 0:              # implicit bool() on a captured value
                return y
            n = np.asarray(y)      # host pull inside the capture
            return y.item()        # and another


        LOOP = make_loop(f, INPUTS)
        """, {7, 9, 10}),
    "shape_branching_static": (
        "host-sync", """\
        import jax
        import jax.numpy as jnp

        @jax.jit
        def pad(q):
            D = q.shape[-1]
            if D % 128:            # trace-time static: fine
                q = jnp.pad(q, ((0, 0), (0, 128 - D % 128)))
            assert q.ndim == 2     # also static
            return q
        """, "host-sync", """\
        import torch.nn.functional as F
        from repro_torch.core.sync import make_loop


        def pad(q):
            D = q.size(-1)
            if D % 128:            # metadata: fine
                q = F.pad(q, (0, 128 - D % 128))
            assert q.dim() == 2    # also metadata
            return q


        LOOP = make_loop(pad, INPUTS)
        """, set()),
    "scan_vs_captured_body": (
        "host-sync", """\
        import jax

        def body(carry, x):
            if carry:              # traced: lax.scan operand
                x = x + 1
            return carry, x

        def run(xs):
            return jax.lax.scan(body, 0, xs)
        """, "host-sync", """\
        from repro_torch.core.sync import make_loop

        def body(carry, x):
            if carry:              # captured: make_loop's body
                x = x + 1
            return carry, x

        def run(xs):
            return make_loop(body, (xs, xs))
        """, {4}),
}


@pytest.mark.parametrize("name", sorted(_MIRRORS))
def test_mirror_pair(tmp_path, name):
    ref_rule, jax_src, port_rule, torch_src, lines = _MIRRORS[name]
    ref = ref_core.run_repolint(make_tree(tmp_path / "jax",
                                          {"src/x.py": jax_src}),
                                rules=(ref_rule,))
    port = run_repolint(make_tree(tmp_path / "torch",
                                  {"src/repro_torch/x.py": torch_src}),
                        rules=(port_rule,))
    assert lines_of(ref, ref_rule) == lines
    assert lines_of(port, port_rule) == lines
    assert {f.rule for f in port.findings} <= {port_rule}


# ------------------------------------------------- mutants of the live tree --
#
# Each copies one real file into a tmp tree, makes one textual change and
# expects exactly one finding of the named rule (none before the change).

_MUTANTS = {
    "clone_dropped_in_generate_on_device": (
        "src/repro_torch/core/sync.py", "use-after-replay",
        'return toks.clone(), {**cache, "index": index.clone()}',
        'return toks, {**cache, "index": index.clone()}'),
    "pre_logits_clone_dropped_in_decode_tick": (
        "src/repro_torch/serving/scheduler.py", "use-after-replay",
        "            pre_logits = pre_logits.clone()\n"
        "            self.fused_steps += 1\n"
        "            self.tracer.count(\"fused_steps\")\n"
        "        self.decode_dispatches += 1\n"
        "        self.tracer.count(\"decode_dispatches\")\n"
        "        toks = sample(",
        "            self.fused_steps += 1\n"
        "            self.tracer.count(\"fused_steps\")\n"
        "        self.decode_dispatches += 1\n"
        "        self.tracer.count(\"decode_dispatches\")\n"
        "        toks = sample("),
    "pool_rebound_in_run_layers_paged": (
        "src/repro_torch/models/transformer.py", "use-after-replay",
        '    """All layers over the paged pool, which is updated in place."""\n',
        '    """All layers over the paged pool, which is updated in place."""\n'
        "    pool = {name: t.clone() for name, t in pool.items()}\n"),
    "item_in_paged_window_loop_body": (
        "src/repro_torch/core/sync.py", "host-sync",
        "    def body(last, tables, lengths, remaining):\n",
        "    def body(last, tables, lengths, remaining):\n"
        "        remaining.sum().item()\n"),
    "synchronize_in_decode_window": (
        "src/repro_torch/serving/scheduler.py", "host-sync",
        "        win_tracer = self.tracer if self.tracer.enabled else None\n",
        "        win_tracer = self.tracer if self.tracer.enabled else None\n"
        "        torch.cuda.synchronize()\n"),
    "paged_step_loop_built_in_step": (
        "src/repro_torch/serving/scheduler.py", "capture-hygiene",
        '        speculative round."""\n',
        '        speculative round."""\n'
        "        paged_step_loop(self.steps, self.params, self.kv.pool,\n"
        "                        self.W, self.kv.max_blocks_per_seq)\n"),
    "assert_in_masked_step": (     # two calls below the window's body
        "src/repro_torch/core/sync.py", "host-sync",
        "    active = remaining > 0\n",
        "    active = remaining > 0\n    assert active.any()\n"),
    "index_clone_dropped_in_generate_host_loop": (
        "src/repro_torch/core/sync.py", "use-after-replay",
        '    return torch.stack(toks, dim=1), {**cache, "index": '
        'index.clone()}',
        '    return torch.stack(toks, dim=1), {**cache, "index": index}'),
    "draft_round_returned_uncopied": (
        "src/repro_torch/serving/spec.py", "use-after-replay",
        "        return toks[:, :k].cpu().numpy()",
        "        return toks[:, :k]"),
    "window_output_kept_on_the_batcher": (
        "src/repro_torch/serving/scheduler.py", "use-after-replay",
        "        toks = toks.cpu().tolist()\n",
        "        self.last_window = toks\n        toks = toks.cpu().tolist()\n"),
    "host_tensor_at_a_tick_call": (
        "src/repro_torch/serving/scheduler.py", "capture-hygiene",
        "logits = loop(last, tables, lengths)",
        "logits = loop(last, tables, torch.as_tensor(lengths))"),
    "item_in_captured_prefill_body": (
        "src/repro_torch/core/engine.py", "host-sync",
        "            def body(tokens, at):\n",
        "            def body(tokens, at):\n                at.item()\n"),
    "verify_logits_read_after_a_later_replay": (
        "src/repro_torch/serving/scheduler.py", "use-after-replay",
        "            logits = call(*stage(tokens, tables, starts, "
        "device=self.device))\n",
        "            logits = call(*stage(tokens, tables, starts, "
        "device=self.device))\n"
        "            call(*stage(tokens, tables, starts, "
        "device=self.device))\n"),
    "spec_verify_call_built_per_round": (
        "src/repro_torch/serving/spec.py", "capture-hygiene",
        "            last = np.asarray([[out[-1]]], np.int64)\n",
        "            last = np.asarray([[out[-1]]], np.int64)\n"
        "            make_call(self._verify, self.device)\n"),
    "unseeded_draw_in_sampler": (
        "src/repro_torch/serving/sampler.py", "determinism",
        '    if cfg.temperature <= 0.0:\n        return torch.argmax(',
        "    noise = torch.randn(3)\n"
        '    if cfg.temperature <= 0.0:\n        return torch.argmax('),
}


@pytest.mark.parametrize("name", sorted(_MUTANTS))
def test_live_tree_mutant(tmp_path, name):
    rel, rule, old, new = _MUTANTS[name]
    text = (REPO / rel).read_text()
    assert text.count(old) == 1, "the mutant's anchor moved"
    for root, src, want in ((tmp_path / "live", text, 0),
                            (tmp_path / "mutant", text.replace(old, new), 1)):
        make_tree(root, {rel: src})
        rep = run_repolint(root, rules=(rule,))
        assert [f.rule for f in rep.findings] == [rule] * want, \
            [f.render() for f in rep.findings]
        assert all(f.path == rel for f in rep.findings)


def test_live_tree_mutant_schema_counter_dropped(tmp_path):
    """Both packages and the doc in one tree; both fused_steps counts of
    the port's scheduler deleted. The port's schema-contract fires once;
    the reference's, which collects emission sites from every walked
    module, is satisfied by the reference's own site and stays silent."""
    ign = shutil.ignore_patterns("__pycache__", "*.pyc", "csrc")
    for sub in ("src/repro", "src/repro_torch"):
        shutil.copytree(REPO / sub, tmp_path / sub, ignore=ign)
    (tmp_path / "docs").mkdir()
    shutil.copy(REPO / "docs/observability.md", tmp_path / "docs")
    sched = tmp_path / "src/repro_torch/serving/scheduler.py"
    site = '            self.tracer.count("fused_steps")\n'
    text = sched.read_text()
    assert text.count(site) == 2

    def both():
        port = run_repolint(tmp_path, rules=("schema-contract",))
        ref = ref_core.run_repolint(tmp_path, rules=("schema-contract",))
        return ([f.message for f in port.findings],
                [f.render() for f in ref.findings
                 if f.rule == "schema-contract"])

    assert both() == ([], [])
    sched.write_text(text.replace(site, ""))
    port, ref = both()
    assert port == ["STATS counter 'fused_steps' has no literal "
                    "tracer.count() site — the metrics ledger can never "
                    "move for it"]
    assert ref == []


# --------------------------------------------------------- live-tree gate --

def test_live_tree_is_clean():
    """The committed tree has zero findings and an empty baseline — every
    grandfathered finding was fixed or pragma'd with a reason."""
    report = run_repolint(REPO)
    assert report.findings == [], "\n".join(
        f.render() for f in report.findings)
    assert report.ok and report.new == [] and report.stale == []
    assert report.n_files > 100   # really walked the port
    paths = {p.relative_to(REPO).as_posix() for p in core.walk_tree(REPO)}
    assert "chip_smoke.py" in paths
    assert "src/repro_torch/core/sync.py" in paths
    assert not any(p.startswith("src/repro/") for p in paths)
    assert "tests/test_analysis.py" not in paths

    baseline = Baseline.load(REPO / core.BASELINE_NAME)
    assert sum(baseline.counts.values()) == 0


def test_rule_names_registered():
    assert set(core.rule_registry()) == set(core.RULE_NAMES) \
        == set(PORT_RULES)
    assert schema.DEFAULT_CONFIG.emission_prefixes == ("src/repro_torch/",)
