"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o lib<name>.so <name>.cu

``--fmad=false`` keeps the kernels' rounding op for op equal to the plain
PyTorch versions they are checked against. The library lands in
``build/exaadmm_tpu_torch/<name>-<hash>/`` beside the package, keyed by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, and
is built at first use; ``build(names)`` compiles several sources at once,
one nvcc process each. Nothing is downloaded: only the sources in ``csrc/``
are compiled. ``build_logs[name]`` keeps nvcc's ``-Xptxas -v`` report
(registers, spills) and ``build_seconds[name]`` the compile time.
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


def _target(name: str):
    """(source, output directory, library path) of ``csrc/<name>.cu``; the
    directory is keyed by the source, every ``csrc/*.cuh`` header and the
    flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    return src, out_dir, out_dir / f"lib{name}.so"


def build(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` not built yet, one nvcc
    process per source, all started together; raise if any fails."""
    started = {}
    for name in names:
        src, out_dir, lib_path = _target(name)
        if lib_path.is_file() or name in started:
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}"
        log = out_dir / f"nvcc.{os.getpid()}.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        started[name] = (proc, cmd, tmp, log, lib_path, time.perf_counter())
    errors = []
    for name, (proc, cmd, tmp, log, lib_path, t0) in started.items():
        proc.wait()
        # a process that ended before an earlier one counts up to that one
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log.read_text()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{build_logs[name]}")
        else:
            os.replace(tmp, lib_path)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library,
    with ``argtypes`` set from ``signatures`` (entry point -> ctypes types;
    every entry point returns a ``cudaError_t`` as int)."""
    if name in _libs:
        return _libs[name]
    _, _, lib_path = _target(name)
    if lib_path.is_file():
        build_seconds.setdefault(name, 0.0)
        build_logs.setdefault(name, f"(cached: {lib_path})")
    else:
        build([name])
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
