"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/`` at the repository root, named
by a digest of the sources and flags, so an edited source never loads a
stale library.  Nothing builds at import: the first launch of a kernel
builds it, or :func:`build` builds several at once, one ``nvcc`` each,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {
    "bsr_matmul": "bsr_matmul.cu",
    "chain_matmul": "chain_matmul.cu",
    "chain_dgrad": "chain_dgrad.cu",
    "chain_wgrad": "chain_wgrad.cu",
}
# No -rdc: chain_matmul.cu's grid-wide barrier (cooperative_groups grid
# sync, under a cooperative launch) needs no relocatable device code since
# CUDA 11; it builds and runs without it on the card's CUDA 12.8.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Build the named kernels that are not built yet, all in parallel.
    Returns ``{name: compiler log}`` (``-Xptxas -v`` register and shared
    memory lines) for every named kernel; raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return {
        name: library_path(name).with_suffix(".log").read_text()
        if library_path(name).with_suffix(".log").exists() else ""
        for name in names
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
