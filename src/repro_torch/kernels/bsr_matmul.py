"""K6: one block-sparse factor ``y = x @ F`` — the wrapper of the CUDA
kernel ``csrc/bsr_matmul.cu``, and its plain PyTorch version.

Replaces ``repro/kernels/bsr_matmul.py:63 bsr_matmul`` (Pallas, TPU).  A
CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version, through the operator ``repro_torch::bsr_matmul`` while a
dispatch mode counts or fakes the call (:mod:`repro_torch.kernels.library`).  ``bsr_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, library
from repro_torch.kernels.chain import DTYPES, SUPPORTED_BT
from repro_torch.kernels.ref import bsr_matmul_ref

# Batch rows per CTA (K6's own tile), from chip_smoke.py's bsr_bt_sweep
# (PERF.md).
BSR_BT = 64
_MAX_GRID_Y = 65535


def bsr_matmul_plain(x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor) -> torch.Tensor:
    """The plain version: gather + einsum, f32 accumulation."""
    return bsr_matmul_ref(x, values, in_idx)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bsr_matmul")
    for suffix in DTYPES.values():
        fn = getattr(lib, f"bsr_matmul_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"bsr_matmul_ctas_{suffix}")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.launch_noop.argtypes = [ctypes.c_void_p]
    lib.launch_noop.restype = ctypes.c_int
    return lib


def launch_config(dtype: torch.dtype, bt: int) -> dict:
    """The resident CTAs (occupancy × SMs) of the current card and one
    CTA's dynamic shared memory at this tile; a launch's grid is
    ``(⌈B / bt⌉, O · ⌈bn / 128⌉)``."""
    smem = ctypes.c_int(0)
    ctas = getattr(_lib(), f"bsr_matmul_ctas_{DTYPES[dtype]}")(bt, ctypes.byref(smem))
    if ctas <= 0:
        raise RuntimeError(f"bsr_matmul occupancy query failed: CUDA error {-ctas}")
    return {"ctas": ctas, "smem_bytes": smem.value}


def _vec(x, values, out) -> int:
    """1 when every row the kernel stages or stores is a whole number of
    16-byte chunks on 16-byte-aligned addresses (cp.async and vector
    stores), else 0 (element loads and stores)."""
    elt = x.element_size()
    _, _, bk, bn = values.shape
    ok = (bk * elt) % 16 == 0 and (bn * elt) % 16 == 0 and (x.shape[1] * elt) % 16 == 0
    return int(ok and all(t.data_ptr() % 16 == 0 for t in (x, values, out)))


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
    x: torch.Tensor, values: torch.Tensor, in_idx: torch.Tensor, *, bt: int = BSR_BT
) -> torch.Tensor:
    """``y = x @ F`` for ``x (B, IB·bk)``, ``values (O, K, bk, bn)``,
    ``in_idx (O, K)`` int32.  Returns ``(B, O·bn)`` in x.dtype.  Runs the
    operator ``repro_torch::bsr_matmul`` (``kernels/library.py``)."""
    if x.is_cuda:
        _check(x, values, in_idx, bt)
    if library.dispatching():
        return _OP(x, values, in_idx, bt)
    return (_launch if x.is_cuda else _plain)(x, values, in_idx, bt)


def _plain(x, values, in_idx, bt):
    return bsr_matmul_plain(x, values, in_idx)


def _fake(x, values, in_idx, bt):
    return x.new_empty((x.shape[0], values.shape[0] * values.shape[3]))


def _flops(x_shape, values_shape, idx_shape, bt, *, out_shape=None, **_):
    from repro_torch.api.dispatch import chain_flops

    return int(chain_flops(x_shape[0], math.prod(values_shape)))


def _launch(x, values, in_idx, bt):
    """K6's launch (the operator's CUDA implementation)."""
    b, in_w = x.shape
    o, k, bk, bn = values.shape
    out = torch.empty((b, o * bn), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = getattr(_lib(), f"bsr_matmul_{DTYPES[x.dtype]}")
    with build.on_device(x.device):
        rc = fn(x.data_ptr(), values.data_ptr(), in_idx.data_ptr(), out.data_ptr(),
                b, in_w, o, k, bk, bn, _vec(x, values, out), bt, build.stream_of(x.device))
    if rc != 0:
        raise RuntimeError(f"bsr_matmul kernel launch failed: CUDA error {rc}")
    bsr_matmul.launches += 1
    return out


_OP = library.define("bsr_matmul", "(Tensor x, Tensor values, Tensor in_idx, int bt) -> Tensor",
                     kernels=("K6", "K6"), cpu=_plain, cuda=_launch, fake=_fake, flops=_flops)
bsr_matmul.launches = 0


def launch_noop() -> None:
    """Launch an empty kernel on the current stream (launch-overhead probe)."""
    rc = _lib().launch_noop(build.stream_of(torch.device("cuda", torch.cuda.current_device())))
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
