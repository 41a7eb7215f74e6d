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

The kernel walks the chain factor by factor on a persistent grid (about
one CTA per SM, cooperative launch, one grid barrier between factors).
:func:`chain_schedule` is its work split: within factor j a work item is
(batch tile of ``bt`` rows, column group of ``group`` consecutive output
blocks), item i being batch tile ``i % n_tiles`` of column group
``i // n_tiles``.  The kernel reads the step table's ``in_blk`` and
``ncols`` columns and the schedule's per-factor table (step offset, out
blocks, slots, column groups).

A CUDA tensor launches the kernel, or raises; a CPU tensor runs the plain
version.  ``chain_matmul.launches`` counts K1 launches and
``chain_matmul.q_launches`` K4 launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.compress import ChainPlan
from repro_torch.kernels import build
from repro_torch.kernels.ref import packed_chain_q_ref, packed_chain_ref

META_COLS = 7
# Batch rows per work item of the chain kernels: the default of the fused
# apply (kernels/ops.py passes one tile to K1/K4 and to K2/K3/K5, and
# dispatch falls back to it without a measured table).
DEFAULT_BT = 16
# K1/K4's own default when called directly: the largest tile reads each
# value block once per 64 batch rows and was the fastest of the three in
# every cell of chip_smoke.py's bt sweep (PERF.md).
FORWARD_BT = 64
SUPPORTED_BT = (16, 32, 64)
MAX_BLOCK = 128  # the kernels' output tile is 128 columns wide
TILE_W = 128  # columns of one K1/K4 work item
MMA_K = 16  # K1/K4 pad a block to a multiple of the MMA depth
MAX_FACTORS = 64  # the K1/K4 factor table is a kernel argument
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


@dataclasses.dataclass(frozen=True)
class ChainSchedule:
    """K1/K4's work split of one plan at one batch and batch tile."""

    block: int
    blkp: int  # the block padded to a multiple of MMA_K
    group: int  # output blocks per work item: TILE_W // blkp
    bt: int
    batch: int
    # per factor: (step offset, out blocks O_j, slots K_j, column groups)
    factors: tuple[tuple[int, int, int, int], ...]

    @property
    def n_tiles(self) -> int:
        return -(-self.batch // self.bt)

    @property
    def items(self) -> tuple[int, ...]:
        """Work items per factor."""
        return tuple(self.n_tiles * f[3] for f in self.factors)

    def item(self, j: int, i: int) -> tuple[range, range, list[list[int]]]:
        """Work item ``i`` of factor ``j`` as the kernel decodes it: its
        batch rows, its output blocks and, per slot k, the step of each
        output block."""
        off, n_out, n_k, _ = self.factors[j]
        grp, tile = divmod(i, self.n_tiles)
        b0, o0 = tile * self.bt, grp * self.group
        blocks = range(o0, min(o0 + self.group, n_out))
        rows = range(b0, min(b0 + self.bt, self.batch))
        return rows, blocks, [[off + o * n_k + k for o in blocks] for k in range(n_k)]


def padded_block(block: int) -> int:
    return -(-block // MMA_K) * MMA_K


@functools.lru_cache(maxsize=64)
def _factor_table(plan: ChainPlan) -> tuple[tuple[int, int, int, int], ...]:
    group = TILE_W // padded_block(plan.block)
    return tuple(
        (plan.offsets[j], plan.out_blocks[j], plan.k_blocks[j], -(-plan.out_blocks[j] // group))
        for j in range(plan.n_factors)
    )


def chain_schedule(plan: ChainPlan, batch: int, bt: int) -> ChainSchedule:
    blkp = padded_block(plan.block)
    return ChainSchedule(plan.block, blkp, TILE_W // blkp, bt, batch, _factor_table(plan))


@functools.lru_cache(maxsize=64)
def _factor_array(plan: ChainPlan):
    flat = [v for row in _factor_table(plan) for v in row]
    return (ctypes.c_int * len(flat))(*flat)


def _suffix(dtype: torch.dtype, qdtype: torch.dtype | None) -> str:
    return DTYPES[dtype] if qdtype is None else f"q_{DTYPES[dtype]}_{QDTYPES[qdtype]}"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("chain_matmul")
    for dtype in DTYPES:
        for qdtype in (None, *QDTYPES):
            suffix = _suffix(dtype, qdtype)
            fn = getattr(lib, f"chain_matmul_{suffix}")
            n_ptr = 6 if qdtype is None else 7
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"chain_matmul_ctas_{suffix}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
    return lib


def launch_config(dtype: torch.dtype, block: int, bt: int, qdtype: torch.dtype | None = None) -> dict:
    """The resident CTAs (occupancy × SMs) of the current card and one
    CTA's dynamic shared memory, for K1 (``qdtype=None``) or K4 at this
    block and tile; a launch's grid is ``min(ctas, max(items))``."""
    smem = ctypes.c_int(0)
    ctas = getattr(_lib(), f"chain_matmul_ctas_{_suffix(dtype, qdtype)}")(padded_block(block), bt, ctypes.byref(smem))
    if ctas <= 0:
        raise RuntimeError(f"chain_matmul occupancy query failed: CUDA error {-ctas}")
    return {"ctas": ctas, "smem_bytes": smem.value}


def _vec(block: int, tensors, scales) -> int:
    """1 when every row the kernel stages is a whole number of 16-byte
    chunks on 16-byte-aligned addresses (cp.async), else 0 (L2 loads)."""
    x = tensors[0]
    ok = (block * x.element_size()) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    if scales is not None:  # codes staged as flat blk*blk bytes, scales as blk floats
        ok = ok and (block * block) % 16 == 0 and block % 4 == 0 and scales.data_ptr() % 16 == 0
    return int(ok)


def _check(x, values, meta, plan, bt, scales):
    """Dtypes, shapes, contiguity and tile; the device is checked apart."""
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
    if plan.n_factors > MAX_FACTORS:
        raise ValueError(f"chain_matmul: at most {MAX_FACTORS} factors; got {plan.n_factors}")


def _check_device(x, values, meta, scales):
    tensors = (x, values, meta) if scales is None else (x, values, meta, scales)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("chain_matmul: x, values, meta (and scales) must lie on one CUDA device")


def chain_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    meta: torch.Tensor,
    *,
    plan: ChainPlan,
    bt: int = FORWARD_BT,
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
    _check_device(x, values, meta, scales)
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
    sched = chain_schedule(plan, b, bt)
    vec = _vec(blk, (x, values, ws, out), scales)
    ints = (plan.n_factors, b, blk, sched.blkp, sched.group, x.shape[1], ws_w, out_w, vec, bt,
            max(sched.items))
    ptrs = (x.data_ptr(), values.data_ptr()) + (() if scales is None else (scales.data_ptr(),))
    ptrs += (meta.data_ptr(), ctypes.addressof(_factor_array(plan)), ws.data_ptr(), out.data_ptr())
    fn = getattr(_lib(), f"chain_matmul_{_suffix(x.dtype, None if scales is None else values.dtype)}")
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain_matmul kernel launch failed: CUDA error {rc}")
    if scales is None:
        chain_matmul.launches += 1
    else:
        chain_matmul.q_launches += 1
    return out


chain_matmul.launches = 0
chain_matmul.q_launches = 0
