"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` source exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
This takes seconds; a build against PyTorch's C++ headers takes minutes.
Libraries go to ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, every header
it includes with ``#include "..."`` (followed recursively, across
directories) and the flags, so an edited source or header is always
rebuilt.  Nothing is compiled at import:
:func:`load_library` builds on first use.
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
from typing import Dict, List

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "included_headers",
           "build_library", "load_library", "BUILD_LOGS"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source stem -> (build seconds, ptxas report) of the builds this process ran
BUILD_LOGS: Dict[str, tuple] = {}
_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


def included_headers(source: Path) -> List[Path]:
    """The headers ``source`` includes with ``#include "..."``, and those
    they include, resolved against the including file's directory."""
    found: List[Path] = []
    todo = [Path(source).resolve()]
    while todo:
        path = todo.pop()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               path.read_text(), re.M):
            header = (path.parent / name).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def build_library(source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` unless an identical build is
    already there; returns the library path."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(included_headers(source)):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    report = "\n".join(line for line in proc.stderr.splitlines()
                       if "ptxas info" in line or "spill" in line)
    out.with_suffix(".log").write_text(report + "\n")
    BUILD_LOGS[source.stem] = (seconds, report)
    return out


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``, once per
    process."""
    source = Path(source)
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build_library(source)))
    return _LOADED[source]
