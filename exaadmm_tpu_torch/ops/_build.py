"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o lib<name>.so <name>.cu

``--fmad=false`` keeps the kernels' rounding op for op equal to the plain
PyTorch versions they are checked against. The library lands in
``build/exaadmm_tpu_torch/<name>-<hash>/`` beside the package, keyed by a
hash of the source and the flags, and is built at first use. Nothing is
downloaded: only the sources in ``csrc/`` are compiled. ``build_logs[name]``
keeps nvcc's ``-Xptxas -v`` report (registers, spills) and
``build_seconds[name]`` the compile time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

build_logs: dict[str, str] = {}
build_seconds: dict[str, float] = {}
_libs: dict[str, ctypes.CDLL] = {}
BUILD_ROOT = CSRC.parent.parent / "build" / "exaadmm_tpu_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library,
    with ``argtypes`` set from ``signatures`` (entry point -> ctypes types;
    every entry point returns a ``cudaError_t`` as int)."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{key}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    else:
        build_seconds.setdefault(name, 0.0)
        build_logs.setdefault(name, f"(cached: {lib_path})")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``; every
    library exports ``error_string(int)`` for the message."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
