"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with
a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``),
under ``build/kernels/`` beside the package. The library's file name carries
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. There is no fallback: a missing ``nvcc`` or
a failed build raises. Libraries build independently: :func:`load_libraries`
runs one nvcc for each, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}  # one per library: different libraries build at once
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when loaded from an earlier build),
#          "ptxas": the -Xptxas -v report}
build_log: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of dyffusion_tpu_torch are built from source on first use"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu``, compiling
    it first if no build of this exact source exists."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{name}-{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".{name}-{digest}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)  # atomic: a concurrent process never loads half a file
            report = (proc.stdout + proc.stderr).strip()
            build_log[name] = {"seconds": seconds, "ptxas": report}
            print(f"[build] {src.name} -> {lib_path.name} in {seconds:.1f} s\n{report}", flush=True)
        else:
            build_log.setdefault(name, {"seconds": 0.0, "ptxas": "(loaded from an earlier build)"})
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """:func:`load_library` for each name, the builds running in parallel."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load_library, names)))
