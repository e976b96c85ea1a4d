"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU unasked."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax_and_no_reference():
    mods = list(_modules())
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\nprint(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_reference_import_in_source(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_chip_smoke_imports_no_jax_or_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set(_imported_roots(tree))
    assert not roots & set(FORBIDDEN)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_paged_cache
    from repro_torch.serving.paged_cache import PagedKVCache
    from repro_torch.serving.scheduler import PagedBatcher
    cfg = get_smoke_config("llama3-8b")
    quant = dict(weight_quant="w4a16", kv_quant="int8")
    pool = dict(num_blocks=4, block_size=32)
    if torch.cuda.is_available():       # on a card the default is the card
        assert PagedBatcher(cfg).device.type == "cuda"
        assert PagedBatcher(cfg, **quant).kv.pool["k"].is_cuda
        assert init_paged_cache(cfg, **pool)["k"].is_cuda
        assert PagedKVCache(cfg, **pool).pool["v"].is_cuda
        return
    for make in (lambda **kw: PagedBatcher(cfg, **kw),
                 lambda **kw: PagedBatcher(cfg, **quant, **kw),
                 lambda **kw: build_model(cfg).init(**kw),
                 lambda **kw: init_paged_cache(cfg, **pool, **kw),
                 lambda **kw: init_paged_cache(cfg, **pool, kv_quant="int8",
                                               **kw),
                 lambda **kw: PagedKVCache(cfg, **pool, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        make(device="cpu")                   # asked for: runs
    for argv in ([], ["--weight-quant", "int8", "--kv-quant", "int8"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--smoke", "--batched", "--paged", "--requests", "1",
                        *argv])


def test_weight_bridge_raises_without_cuda_unless_asked_for_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    cfg = get_smoke_config("llama3-8b").with_(n_layers=1)
    np_params = {"layers": {"attn_norm": np.ones((1, cfg.d_model),
                                                 np.float32)}}
    if torch.cuda.is_available():       # on a card the default is the card
        assert params_from_numpy(np_params, cfg)["layers"]["attn_norm"] \
            .is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(np_params, cfg)
    out = params_from_numpy(np_params, cfg, "cpu")
    assert out["layers"]["attn_norm"].device.type == "cpu"


def test_engine_entry_points_raise_without_cuda_unless_asked_for_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.sync import measure_dispatch_overhead
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_cache
    cfg = get_smoke_config("llama3-8b")
    if torch.cuda.is_available():
        assert InferenceEngine(cfg).device.type == "cuda"
        assert init_cache(cfg, 1, 8)["index"].is_cuda
        return
    for make in (lambda **kw: InferenceEngine(cfg, **kw),
                 lambda **kw: init_cache(cfg, 1, 8, **kw),
                 lambda **kw: measure_dispatch_overhead(3, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        make(device="cpu")                   # asked for: runs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--prompt-len", "12", "--new-tokens", "2"])


def test_chip_smoke_refuses_alone_or_without_cuda(tmp_path):
    """chip_smoke.py fails, printing no result, in a directory that holds
    nothing else of the repository, and (here) on a host without CUDA."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone]
    if not torch.cuda.is_available():
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, script
        assert '"ok"' not in out.stdout, script
