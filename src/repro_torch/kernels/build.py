"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/`` at the repository root, named
by a digest of the sources, flags and parts, so an edited source never
loads a stale library.  Nothing builds at import: the first launch of a
kernel builds it, or :func:`build` builds several at once.  A source with
several entry points compiles in :data:`PARTS` (``FAUST_PARTS`` in
``pipeline.cuh``), one ``nvcc`` a part, every part of every source started
together, and its parts link into its library.  :func:`on_device` and :func:`stream_of` are what a
wrapper needs around its ctypes call, at a few microseconds less host time
a launch than ``torch.cuda.device`` and ``current_stream()`` (at serving
batch the wrappers' host time nears the kernels' own).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {
    "bsr_matmul": "bsr_matmul.cu",
    "chain_matmul": "chain_matmul.cu",
    "chain_dgrad": "chain_dgrad.cu",
    "chain_wgrad": "chain_wgrad.cu",
}
# Each part instantiates the templates of every PARTS-th of its source's
# eight entry points: those instantiations set a source's build time.
PARTS = {"chain_matmul": 2, "chain_dgrad": 2, "chain_wgrad": 4}
# No -rdc: chain_matmul.cu's grid-wide barrier (cooperative_groups grid
# sync, under a cooperative launch) needs no relocatable device code since
# CUDA 11; it builds and runs without it on the card's CUDA 12.8.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(PARTS.items()))).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Build the named kernels that are not built yet: every part of
    every source compiles at once, one ``nvcc`` each, then each source's
    parts link into its library.  Returns ``{name: compiler log}``
    (``-Xptxas -v`` register and shared memory lines) for every named
    kernel; raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        n = PARTS.get(name, 1)
        parts = []
        for k in range(n):
            obj = work / f"part{k}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, f"-DFAUST_PARTS={n}", f"-DFAUST_PART={k}", "-c", "-o", str(obj),
                   str(CSRC / SOURCES[name])]
            parts.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), obj))
        jobs[name] = (parts, work, target)
    failed = []
    for name, (parts, work, target) in jobs.items():
        logs = [proc.communicate()[0] for proc, _ in parts]
        ok = all(proc.returncode == 0 for proc, _ in parts)
        if ok:
            lib = work / "lib.so"
            link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(lib), *(str(obj) for _, obj in parts)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            ok = link.returncode == 0
        if ok:
            target.with_suffix(".log").write_text("\n".join(logs))
            os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{name}:\n" + "\n".join(logs))
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return {
        name: library_path(name).with_suffix(".log").read_text()
        if library_path(name).with_suffix(".log").exists() else ""
        for name in names
    }


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (the one a
    ctypes launch runs on): nothing to do when it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
