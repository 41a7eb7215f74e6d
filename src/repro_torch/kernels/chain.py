"""K1: the fused FAµST chain ``y = x @ F_1 ⋯ F_J`` in one launch, and K4:
the same chain on int8/fp8 codes with f32 row scales — the wrapper of the
CUDA kernels ``csrc/chain_matmul.cu``, and their plain PyTorch versions.

Replaces ``repro/kernels/chain.py:125 chain_matmul`` (Pallas, TPU), K4
that function called with ``scales=``.  The
step table ``meta (S, META_COLS)`` (built by
:func:`repro_torch.kernels.ops.chain_meta`) has, per step s:

    0 in_blk   input block of the current activation
    1 out_blk  output block this step accumulates into
    2 parity   ping-pong buffer holding this factor's input (j % 2)
    3 is_k0    first slot of an output block: zero the accumulator
    4 is_kend  last slot of an output block: flush the accumulator
    5 is_last  step of the final factor: flush to the output
    6 ncols    valid columns of the flushed block (tail zeroed beyond)

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version.  ``chain_matmul.launches`` counts K1 launches and
``chain_matmul.q_launches`` K4 launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.compress import ChainPlan
from repro_torch.kernels import build
from repro_torch.kernels.ref import packed_chain_q_ref, packed_chain_ref

META_COLS = 7
# Batch rows per CTA.  The fused kernel runs one CTA per batch tile; the
# batch-tile sweep of chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W, f32,
# gemma-2b up-projection chain) measured 10.95 / 18.20 / 14.66 ms at
# B = 128 and 11.34 / 18.55 / 14.88 ms at B = 4096 for bt = 16 / 32 / 64.
DEFAULT_BT = 16
SUPPORTED_BT = (16, 32, 64)
MAX_BLOCK = 128  # the kernels' output tile is 128 columns wide
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K4's stored code types
QDTYPES = {torch.int8: "int8", torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}


def chain_matmul_plain(
    x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor, *, plan: ChainPlan
) -> torch.Tensor:
    """The plain version: the per-factor walk of ``ref.packed_chain_ref``."""
    return packed_chain_ref(x, values, meta[:, 0], plan)


def chain_matmul_q_plain(
    x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, meta: torch.Tensor, *, plan: ChainPlan
) -> torch.Tensor:
    """K4's plain version: f32 dequantized blocks, then the walk."""
    return packed_chain_q_ref(x, values, meta[:, 0], plan, scales)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("chain_matmul")
    for suffix in DTYPES.values():
        fn = getattr(lib, f"chain_matmul_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for qsuffix in QDTYPES.values():
            fn = getattr(lib, f"chain_matmul_q_{suffix}_{qsuffix}")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(x, values, meta, plan, bt, scales):
    tensors = (x, values, meta) if scales is None else (x, values, meta, scales)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("chain_matmul: x, values, meta (and scales) must lie on one CUDA device")
    if scales is None:
        if x.dtype not in DTYPES or values.dtype != x.dtype:
            raise TypeError(f"chain_matmul takes f32 or bf16 x and values of one dtype; got {x.dtype}, {values.dtype}")
    else:
        if x.dtype not in DTYPES or values.dtype not in QDTYPES or scales.dtype != torch.float32:
            raise TypeError(
                "chain_matmul(scales=) takes f32 or bf16 x, int8/fp8 codes and f32 scales; "
                f"got {x.dtype}, {values.dtype}, {scales.dtype}"
            )
        if tuple(scales.shape) != (plan.n_steps, plan.block) or not scales.is_contiguous():
            raise ValueError(
                f"chain_matmul: scales must be contiguous ({plan.n_steps}, {plan.block}); got {tuple(scales.shape)}"
            )
    if meta.dtype != torch.int32:
        raise TypeError(f"chain_matmul: meta must be int32; got {meta.dtype}")
    blk, s = plan.block, plan.n_steps
    if blk > MAX_BLOCK:
        raise ValueError(f"chain_matmul: block {blk} exceeds the kernel's {MAX_BLOCK}")
    if x.ndim != 2 or x.shape[1] != plan.in_blocks[0] * blk:
        raise ValueError(f"chain_matmul: x must be (B, {plan.in_blocks[0] * blk}); got {tuple(x.shape)}")
    if tuple(values.shape) != (s, blk, blk) or tuple(meta.shape) != (s, META_COLS):
        raise ValueError(f"chain_matmul: values {tuple(values.shape)} / meta {tuple(meta.shape)} do not fit the plan")
    if not (x.is_contiguous() and values.is_contiguous() and meta.is_contiguous()):
        raise ValueError("chain_matmul: x, values and meta must be contiguous")
    if bt not in SUPPORTED_BT:
        raise ValueError(f"chain_matmul: bt must be one of {SUPPORTED_BT}; got {bt}")


def chain_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    meta: torch.Tensor,
    *,
    plan: ChainPlan,
    bt: int = DEFAULT_BT,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused ``y = x @ F_1 @ ... @ F_J``: ``x (B, IB_1·blk)``, ``values
    (S, blk, blk)``, ``meta (S, META_COLS)`` int32.  Returns
    ``(B, O_J·blk)`` with ragged tails zeroed; λ and slicing are the
    caller's.  With ``scales (S, blk)`` f32, ``values`` are int8/fp8 codes
    and block row r of step s is ``values[s, r]·scales[s, r]`` (K4)."""
    if not x.is_cuda:
        if scales is None:
            return chain_matmul_plain(x, values, meta, plan=plan)
        return chain_matmul_q_plain(x, values, scales, meta, plan=plan)
    _check(x, values, meta, plan, bt, scales)
    b, blk = x.shape[0], plan.block
    out_w = plan.out_blocks[-1] * blk
    out = torch.empty((b, out_w), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    # the widest intermediate activation, not max_blocks: factor 1 reads x
    # and factor J writes the output directly
    ws_w = max(plan.in_blocks[1:], default=0) * blk
    ws = torch.empty((2, b, ws_w) if ws_w else (0,), dtype=x.dtype, device=x.device)
    ints = (b, plan.n_steps, blk, x.shape[1], ws_w, out_w, plan.offsets[1], bt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if scales is None:
            fn = getattr(_lib(), f"chain_matmul_{DTYPES[x.dtype]}")
            rc = fn(x.data_ptr(), values.data_ptr(), meta.data_ptr(), ws.data_ptr(), out.data_ptr(),
                    *ints, stream)
        else:
            fn = getattr(_lib(), f"chain_matmul_q_{DTYPES[x.dtype]}_{QDTYPES[values.dtype]}")
            rc = fn(x.data_ptr(), values.data_ptr(), scales.data_ptr(), meta.data_ptr(),
                    ws.data_ptr(), out.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"chain_matmul kernel launch failed: CUDA error {rc}")
    if scales is None:
        chain_matmul.launches += 1
    else:
        chain_matmul.q_launches += 1
    return out


chain_matmul.launches = 0
chain_matmul.q_launches = 0
