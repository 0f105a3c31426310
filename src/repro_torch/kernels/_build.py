"""Build and load the port's CUDA kernel library.

``kernels/csrc/ftp_bsr.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes.  The build
happens at first use, from the checkout's sources only, into
``<repo>/build/kernels/`` (listed in .gitignore).  The library name carries a
hash of the source and the flags, so a second run with the same sources
loads the library it finds instead of building again.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "ftp_bsr.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path() -> Path:
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libftp_bsr-{key}.so"


def build() -> dict:
    """Build the kernel library if it is missing.  Returns {"path",
    "seconds", "log"} (log = nvcc's output, with ``-Xptxas -v``'s registers,
    shared memory and spills; empty when the library was already built)."""
    lib = library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": proc.stdout}


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing."""
    return ctypes.CDLL(build()["path"])
