"""K6: one block-sparse factor ``y = x @ F`` — the wrapper of the CUDA
kernel ``csrc/bsr_matmul.cu``, and its plain PyTorch version.

Replaces ``repro/kernels/bsr_matmul.py:63 bsr_matmul`` (Pallas, TPU).  A
CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version.  ``bsr_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.chain import DTYPES, SUPPORTED_BT
from repro_torch.kernels.ref import bsr_matmul_ref

# Batch rows per CTA: the batch-tile sweep of chip_smoke.py (NVIDIA H100
# 80GB HBM3, 700 W, f32, three launches over the gemma-2b up-projection
# chain) measured 0.54 / 0.48 / 0.36 ms at B = 128 and 8.17 / 5.48 /
# 4.07 ms at B = 4096 for bt = 16 / 32 / 64.
DEFAULT_BT = 64
_MAX_GRID_Y = 65535


def bsr_matmul_plain(x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor) -> torch.Tensor:
    """The plain version: gather + einsum, f32 accumulation."""
    return bsr_matmul_ref(x, values, in_idx)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bsr_matmul")
    for suffix in DTYPES.values():
        fn = getattr(lib, f"bsr_matmul_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.launch_noop.argtypes = [ctypes.c_void_p]
    lib.launch_noop.restype = ctypes.c_int
    return lib


def _check(x, values, in_idx, bt):
    if not (values.is_cuda and in_idx.is_cuda) or len({x.device, values.device, in_idx.device}) != 1:
        raise ValueError("bsr_matmul: x, values and in_idx must lie on one CUDA device")
    if x.dtype not in DTYPES or values.dtype != x.dtype:
        raise TypeError(f"bsr_matmul takes f32 or bf16 x and values of one dtype; got {x.dtype}, {values.dtype}")
    if in_idx.dtype != torch.int32:
        raise TypeError(f"bsr_matmul: in_idx must be int32; got {in_idx.dtype}")
    if x.ndim != 2 or values.ndim != 4:
        raise ValueError(f"bsr_matmul: x (B, IB·bk) and values (O, K, bk, bn); got {tuple(x.shape)}, {tuple(values.shape)}")
    o, k, bk, bn = values.shape
    if tuple(in_idx.shape) != (o, k) or x.shape[1] % bk:
        raise ValueError(f"bsr_matmul: in_idx {tuple(in_idx.shape)} / x {tuple(x.shape)} do not fit values {tuple(values.shape)}")
    if not (x.is_contiguous() and values.is_contiguous() and in_idx.is_contiguous()):
        raise ValueError("bsr_matmul: x, values and in_idx must be contiguous")
    if bt not in SUPPORTED_BT:
        raise ValueError(f"bsr_matmul: bt must be one of {SUPPORTED_BT}; got {bt}")
    if o * -(-bn // 128) > _MAX_GRID_Y:
        raise ValueError(f"bsr_matmul: {o} output blocks of width {bn} exceed the launch grid")


def bsr_matmul(
    x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor, *, bt: int = DEFAULT_BT
) -> torch.Tensor:
    """``y = x @ F`` for ``x (B, IB·bk)``, ``values (O, K, bk, bn)``,
    ``in_idx (O, K)`` int32.  Returns ``(B, O·bn)`` in x.dtype."""
    if not x.is_cuda:
        return bsr_matmul_plain(x, values, in_idx)
    _check(x, values, in_idx, bt)
    b, in_w = x.shape
    o, k, bk, bn = values.shape
    out = torch.empty((b, o * bn), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = getattr(_lib(), f"bsr_matmul_{DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), values.data_ptr(), in_idx.data_ptr(), out.data_ptr(),
                b, in_w, o, k, bk, bn, bt, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_matmul kernel launch failed: CUDA error {rc}")
    bsr_matmul.launches += 1
    return out


bsr_matmul.launches = 0


def launch_noop() -> None:
    """Launch an empty kernel on the current stream (launch-overhead probe)."""
    rc = _lib().launch_noop(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
