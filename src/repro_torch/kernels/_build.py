"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library under ``build/kernels/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<stem>-<hash>.so <source>

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A build happens
at first use, inside the call that launches a kernel, never at import: the
CPU has no nvcc. :func:`build` starts one nvcc per stale source, all at
once, and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only where the CUDA toolkit is installed")
    return path


def library_path(source: Path) -> Path:
    """Where `source` is built: its stem plus a hash of source and flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> Dict[Path, Tuple[float, str]]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {source: (seconds, nvcc output)}
    for the sources built (the output holds ``-Xptxas -v``'s register and
    spill counts). Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        src = Path(src)
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    done, failed = {}, []
    for src, lib, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
        done[src] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(source: Path) -> ctypes.CDLL:
    """The shared library of `source`, built first if it is stale. Kept for
    the life of the process, so a launch does not hash the source again."""
    source = Path(source)
    if source not in _LOADED:
        lib = library_path(source)
        build([source])
        _LOADED[source] = ctypes.CDLL(str(lib))
    return _LOADED[source]
