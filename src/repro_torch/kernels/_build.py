"""Build and load the port's CUDA kernel libraries.

Every ``kernels/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with ctypes.
The builds happen at first use, from the checkout's sources only, into
``<repo>/build/kernels/`` (listed in .gitignore), one ``nvcc`` process per
source, all started together.  A library's name carries a hash of its
source, the shared headers and the flags, so a second run with the same
sources loads the library it finds instead of building again.  nvcc's
output (``-Xptxas -v``: each kernel's registers, shared memory and spill
bytes) is kept beside the library, so a run that finds it built still
reads what ptxas said.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> dict[str, Path]:
    """{library name: source} for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, dict]:
    """Build every kernel library that is missing, one ``nvcc`` per source,
    in parallel.  Returns {name: {"path", "seconds", "log"}} (log = nvcc's
    output, with ``-Xptxas -v``'s registers, shared memory and spills, from
    this build or the one that made the library; seconds 0 when it was
    already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    out, running = {}, {}
    for name, src in sources().items():
        lib = library_path(name)
        if lib.exists() and _log_path(lib).exists():
            out[name] = {"path": str(lib), "seconds": 0.0,
                         "log": _log_path(lib).read_text()}
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        _log_path(tmp).write_text(log)
        os.replace(_log_path(tmp), _log_path(lib))
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        out[name] = {"path": str(lib), "seconds": time.perf_counter() - t0,
                     "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu`` (every
    missing library is built first)."""
    path = library_path(name)
    if not path.exists():
        build()
    return ctypes.CDLL(str(path))


def on_card(device):
    """The context a ctypes launch on ``device``'s tensors runs in: that
    card made current (a launch runs on the current device, whatever the
    tensors' stream), or nothing to switch when the process sees one card."""
    import torch

    if torch.cuda.device_count() > 1:
        return torch.cuda.device(device)
    return contextlib.nullcontext()
