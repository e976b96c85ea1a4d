"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exports a plain C interface and
compiles into ``build/kernels/lib<name>.so`` under the repository root (a
directory git ignores), for ``sm_90a`` only. Building happens at first use,
never at import, and only from the sources in the checkout: a library is
rebuilt whenever its source or any shared header ``csrc/*.cuh`` is newer.
There is no fallback: a failed build raises. ``entry`` binds one C entry
point for a wrapper: its launches go to the current stream (the capture
stream while a CUDA graph is being captured), and a nonzero return raises
with CUDA's name for the error. ``counted`` registers a wrapper's launch
counter, ``.launches``, which the wrapper bumps in Python where it launches
its kernel; a replayed graph runs no Python, so ``core.sync.CapturedLoop``
adds what its capture recorded (``launch_counts``) on every replay.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("hetero_matmul", "quant_matmul", "flash_attention",
           "decode_attention", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], Callable[..., None]] = {}
# every wrapper whose ``.launches`` counts its kernel's launches
COUNTED: list[Callable] = []


def counted(wrapper: Callable) -> Callable:
    """Give ``wrapper`` a launch counter (``.launches = 0``) and register it
    in ``COUNTED``."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def launch_counts() -> dict[Callable, int]:
    """``{wrapper: .launches}`` of every registered wrapper."""
    return {w: w.launches for w in COUNTED}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str, csrc: Path = CSRC, lib: Path | None = None) -> bool:
    """Whether ``lib<name>.so`` is missing or older than its source or any
    shared header of ``csrc``."""
    lib = lib or library_path(name)
    newest = max(p.stat().st_mtime
                 for p in (csrc / f"{name}.cu", *csrc.glob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def build(names=SOURCES) -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` each, all started together.
    Returns ``{name: compiler output}`` (``-Xptxas -v`` register and shared
    memory report) for what was built; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, *argtypes) -> Callable[..., None]:
    """``csrc/<name>.cu``'s C entry ``symbol`` (argument types ``argtypes``
    but the trailing stream; it returns a ``cudaError_t``), bound once.
    ``launch(device, *args)`` calls it on ``device``'s current stream and
    raises with the library's ``repro_error_string`` if it fails."""
    launch = _bound.get((name, symbol))
    if launch is not None:
        return launch
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    describe = lib.repro_error_string
    describe.argtypes = [ctypes.c_int]
    describe.restype = ctypes.c_char_p

    def launch(device, *args) -> None:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: "
                               f"{describe(err).decode()} ({err})")

    _bound[(name, symbol)] = launch
    return launch
