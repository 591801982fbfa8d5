"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<digest>.so``
under ``build/kernels/`` at the root of the checkout (``.gitignore`` lists
``build/``).  The digest covers the source, the headers beside it and the
flags, so an edited source never loads a stale library.  Sources compile at
first use, never at import: a host without ``nvcc`` imports this package
and runs the plain versions on CPU tensors.

The sources expose a plain C interface (``extern "C"``), so the build needs
no PyTorch headers and takes seconds.  :func:`library` is guarded by a lock,
because the pipeline's worker threads can reach a kernel together on the
first messages; :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register/shared-memory report) per built source
build_logs: Dict[str, str] = {}


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the toolkit at ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    path = shutil.which("nvcc")
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if path is None and (home / "bin" / "nvcc").exists():
        path = str(home / "bin" / "nvcc")
    if path is None:
        raise RuntimeError(f"nvcc was not found on PATH or under {home}/bin: "
                           f"the CUDA kernels cannot be built on this host")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _tmp(out: Path) -> Path:
    # written beside the target and renamed, so a reader never loads a
    # half-written library
    return out.with_name(f"{out.name}.{os.getpid()}.tmp")


def _start(src: Path, out: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(out)), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen, out: Path) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(_tmp(out), out)


def build_all() -> Dict[str, float]:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0.0 where the library was already current)."""
    targets = {src.stem: (src, _target(src)) for src in sources()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with _lock:
        procs = {name: _start(src, out)
                 for name, (src, out) in targets.items() if not out.exists()}
        seconds = dict.fromkeys(targets, 0.0)
        errors = []
        for name, proc in procs.items():     # wait for every compiler
            try:
                _finish(name, proc, targets[name][1])
            except RuntimeError as err:
                errors.append(str(err))
            seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        out = _target(src)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish(name, _start(src, out), out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
