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

It also holds what every kernel wrapper shares: the launch counter, the
check for a Hopper card, and the shared-memory limit of an sm_90 block.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

from repro_torch.spans import REGISTRY

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dynamic shared memory a block may take on sm_90 (227 KB)
MAX_SMEM_BYTES = 232_448

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# every LaunchCounter, in the order the kernel modules made them
COUNTERS: List["LaunchCounter"] = []
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
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Its first load, with the build, is the span ``kernels.library`` of the
    process-wide ``repro_torch.spans.REGISTRY``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        with REGISTRY.span("kernels.library"):
            src = CSRC / f"{name}.cu"
            out = _target(src)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, _start(src, out), out)
            lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


class LaunchCounter:
    """A thread-safe count of kernel launches.  Every counter made is
    listed in :data:`COUNTERS`, so that a CUDA graph can count its
    replays' launches: a replay runs no Python, so no wrapper counts it.
    ``symbols`` names the ``__global__`` functions one counted launch
    runs, so that the launches a captured graph holds can be counted from
    its kernel nodes' names (:func:`count_launches`).  Where two counters
    share one function template, ``args`` tells them apart: a regular
    expression that the mangled template arguments (``I...E``, right
    after the identifier) must match.  Each thread's own launches are
    also tallied (:meth:`mine`), so that a capture takes back exactly what
    its thread counted while other threads launch."""

    def __init__(self, symbols: Sequence[str] = (), args: str = ""):
        self._lock = threading.Lock()
        self._n = 0
        self._local = threading.local()
        self.symbols = tuple(symbols)
        # an Itanium-mangled name spells an identifier as <length><name>
        self._pattern = re.compile("|".join(
            f"{len(s)}{re.escape(s)}{args}" for s in self.symbols) or "(?!)")
        COUNTERS.append(self)

    def counts(self, name: str) -> bool:
        """Whether the kernel function named ``name`` (mangled) is one of
        this counter's ``symbols``."""
        return self._pattern.search(name) is not None

    def incr(self) -> None:
        with self._lock:
            self._n += 1
        self._local.n = self.mine() + 1

    def mine(self) -> int:
        """Every launch :meth:`incr` counted on the calling thread."""
        return getattr(self._local, "n", 0)

    def add(self, n: int) -> None:
        """Add ``n`` launches: a graph's replay adds those its capture
        recorded; a negative ``n`` takes back what a capture counted, since
        a capture launches nothing."""
        with self._lock:
            self._n += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def count_launches(names: Sequence[str]) -> Dict["LaunchCounter", int]:
    """For each counter of :data:`COUNTERS` with ``symbols``, how many of
    the kernel function ``names`` (a graph's kernel nodes) are its."""
    return {c: sum(map(c.counts, names)) for c in COUNTERS if c.symbols}


def require_hopper(device, what: str) -> None:
    """Raise unless ``device`` is an sm_90 card, which the sources target."""
    import torch
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the {what} kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}")
