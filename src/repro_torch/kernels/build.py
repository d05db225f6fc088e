"""Build the port's hand-written CUDA kernels and count their launches.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point; headers
shared by several kernels live in ``kernels/csrc/`` (``INCLUDE_DIR``, on
the include path).  ``load`` compiles a source with ``nvcc`` for
``sm_90a`` into a shared library under ``build/kernels/`` at the repo root
(listed in ``.gitignore``), named by a hash of the source, of every port
header it includes (directly or through another header) and of the flags,
so an unchanged source is compiled once and reused and a header edit
rebuilds its includers; the library is bound with ``ctypes``.  ``build``
starts one ``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.  A missing compiler or a failed build
raises; there is no fallback.

``LAUNCHES`` holds one plain integer per kernel: its wrapper adds one each
time it launches the kernel, and nowhere else.  ``ROUTE_LAUNCHES`` splits
the count of a wrapper that chooses among several kernels by shape
(``"<kernel>:<route>"``, e.g. ``"dropout_matmul:wgmma"``).
``BUILD_SECONDS`` holds the wall time of each source's own ``nvcc`` in
this process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

# -split-compile=0: each nvcc runs its device optimizer and ptxas over
# parts of the source on as many threads as there are CPUs (the decode
# source's 128 template instances build in about 60 s instead of 130 on
# 8 CPU cores beside the other four sources)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"

LAUNCHES: Dict[str, int] = {}
ROUTE_LAUNCHES: Dict[str, int] = {}
BUILD_SECONDS: Dict[str, float] = {}

_loaded: Dict[Path, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(name: str, route: str) -> None:
    """One launch of kernel ``name`` by way of ``route``."""
    LAUNCHES[name] += 1
    key = f"{name}:{route}"
    ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def included_headers(source: Path) -> List[Path]:
    """The port headers ``source`` includes, directly or through another
    header, in first-seen order: ``#include "name"`` resolved as nvcc
    does, next to the including file first, then in ``INCLUDE_DIR``.
    Names found in neither place are not the port's and are skipped."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        src = todo.pop(0)
        for name in _INCLUDE.findall(src.read_bytes()):
            for where in (src.parent, INCLUDE_DIR):
                path = (where / name.decode()).resolve()
                if path.is_file():
                    if path not in seen:
                        seen.append(path)
                        todo.append(path)
                    break
    return seen


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: keyed by the bytes of the source and of
    every port header it includes, and by the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together.  Raises with the compiler's output when
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [src for src in sources if not library_path(src).exists()]
    nvcc = _nvcc() if missing else None
    jobs = []
    t0 = time.perf_counter()
    for src in missing:
        lib = library_path(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(tmp.with_suffix(".log"), "w+b")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", str(tmp),
               str(src)]
        jobs.append((src, lib, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    errors, pending = [], list(jobs)
    while pending:                      # poll, so each job gets its own time
        for job in [j for j in pending if j[4].poll() is not None]:
            pending.remove(job)
            src, lib, tmp, log, proc = job
            BUILD_SECONDS[src.name] = time.perf_counter() - t0
            log.seek(0)
            out = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                errors.append(f"{lib.name}:\n{out.decode(errors='replace')}")
                continue
            os.replace(tmp, lib)        # atomic: concurrent builds agree
        if pending:
            time.sleep(0.05)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [library_path(src) for src in sources]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first when needed."""
    lib = library_path(source)
    if lib not in _loaded:
        build([source])
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]
