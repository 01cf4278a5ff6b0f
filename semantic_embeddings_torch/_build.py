"""Builds the hand-written CUDA kernels in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>/lib<name>.so`` at the
repository root, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
rebuilds and an unchanged one loads the library built before.
The library is loaded with ``ctypes``; the caller declares its functions'
``argtypes``.  Nothing is prebuilt or downloaded: a missing ``nvcc`` or a
failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
#: name -> (seconds the build took, the compiler's output); empty for a
#: library that was already on disk
build_logs: dict[str, tuple[float, str]] = {}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless a library of this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_logs[name] = (seconds, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
