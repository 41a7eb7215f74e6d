"""Gradient compression with error feedback.  Counterpart of
:mod:`repro.optim.compression`.

* **EF top-k** (Stich et al.): keep the k largest-magnitude entries of each
  gradient leaf, k = ⌈ratio · size⌉; what was dropped is carried to the
  next step.  The accumulator ``g + r`` is f32, the kept entries are cast
  back to the gradient's dtype, and the residual is ``acc − kept`` taken
  in f32 *before* that cast, as the reference computes it.
* **PowerSGD** (Vogels et al.): rank-r ``G ≈ P Qᵀ`` with a warm-started Q
  and one power iteration; error feedback on the residual.

Gradients, parameters and residuals are ``{name: tensor}`` dicts (the
port's parameters are named, where the reference's are a tree).  Only
floating leaves are compressed or carry a residual: the reference's
scalar residuals of integer leaves (FAµST block indices) have no
counterpart, since those are buffers and not parameters here.  The
compress functions update the state in place, leaf by leaf, so a step
holds one leaf's temporaries at a time; EF top-k's ``ok`` (a 0-d bool
tensor, default true) is the trainer's NaN guard: where it is false every
residual keeps its bits, decided on the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


# ---------------------------------------------------------------------------
# EF top-k
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopKConfig:
    ratio: float = 0.01  # fraction of entries kept per leaf


@dataclasses.dataclass
class EFState:
    residual: dict  # {name: f32 tensor}, one per floating parameter


def n_kept(size: int, ratio: float) -> int:
    """k of a leaf of ``size`` entries: ⌈size · ratio⌉, at least 1."""
    return max(int(math.ceil(size * ratio)), 1)


def ef_topk_init(params: dict) -> EFState:
    """f32 zero residuals for every floating parameter."""
    return EFState({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items() if _is_float(p)})


def topk_mask_flat(v: torch.Tensor, k: int) -> torch.Tensor:
    """f32 0/1 mask of the ``k`` entries of largest ``|v|`` of a 1-D ``v``.
    Ties at the k-th magnitude go to the lowest indices, the rule of
    ``lax.top_k`` and of the stable sort in
    :func:`repro_torch.core.projections._topk_mask_flat`; the set is that
    one's.  A selection, not a sort: the k-th magnitude from
    ``torch.topk``'s values, every entry above it, then the entries equal
    to it in index order up to k.  No value leaves the device."""
    a = v.abs()
    if k >= a.numel():
        return torch.ones_like(a, dtype=torch.float32)
    kth = torch.topk(a, k, sorted=False).values.min()
    above = a > kth
    tie = a == kth
    need = k - above.sum(dtype=torch.int32)
    tie &= torch.cumsum(tie, 0, dtype=torch.int32) <= need
    return (above | tie).to(torch.float32)


def topk_mask_sharded(v: torch.Tensor, k: int, block, mesh) -> torch.Tensor:
    """:func:`topk_mask_flat`'s mask of the whole leaf, at this rank's
    ``block`` of it (``v``: the block, flattened), on ``mesh``: the k-th
    largest magnitude of the whole leaf from every rank's own k largest,
    gathered over the axes the block is split over; the entries above it
    counted over them; then the ties, in the whole leaf's row-major index
    order, up to k (each rank offers its ``need`` first, the group keeps
    the ``need`` lowest global indices).  A whole block is
    :func:`topk_mask_flat` itself."""
    from repro_torch.distributed import mesh as _mesh
    from repro_torch.distributed.layout import COLLECTIVES

    if not block.axes:
        return topk_mask_flat(v, k)
    group = mesh.group(block.axes)
    a = v.abs()
    if k >= math.prod(block.global_shape):
        return torch.ones_like(a, dtype=torch.float32)
    COLLECTIVES["sum"] += 3
    cand = _mesh.all_gather(torch.topk(a, min(k, a.numel()), sorted=False).values, group, 0)
    kth = torch.topk(cand, k, sorted=False).values.min()
    above = a > kth
    tie = a == kth
    need = k - int(_mesh.all_reduce(above.sum(dtype=torch.int64), group))
    if need <= 0:
        return above.to(torch.float32)
    local = torch.nonzero(tie).reshape(-1)  # ascending local, so ascending global index
    gidx = torch.zeros_like(local)
    stride = 1
    for d in reversed(range(len(block.shape))):
        coord = torch.div(local, math.prod(block.shape[d + 1:]), rounding_mode="floor") % block.shape[d]
        gidx += (coord + block.offset[d]) * stride
        stride *= block.global_shape[d]
    offer = torch.full((need,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=a.device)
    offer[:min(need, gidx.numel())] = gidx[:need]
    last = torch.sort(_mesh.all_gather(offer, group, 0)).values[need - 1]
    keep = torch.zeros_like(tie)
    keep[local[gidx <= last]] = True
    return (above | keep).to(torch.float32)


def ef_topk_compress(cfg: TopKConfig, grads: dict, state: EFState, ok=None,
                     select=None) -> tuple[dict, EFState, dict]:
    """``(compressed grads, state, {"ef_residual_norm"})``; ``state``'s
    residuals are updated in place (kept as they were where ``ok`` is
    false).  The norm is that of the new residuals, a device tensor.
    ``select(name, flat)`` gives the f32 mask of the entries kept of a
    leaf's flattened accumulator (default: :func:`topk_mask_flat` of
    :func:`n_kept` entries; a mesh selects over the whole leaf whose block
    ``flat`` is)."""
    comp, sq = {}, []
    for name, g in grads.items():
        if not _is_float(g) or name not in state.residual:
            comp[name] = g
            continue
        acc = g.float() + state.residual[name]
        flat = acc.view(-1)
        mask = topk_mask_flat(flat, n_kept(flat.numel(), cfg.ratio)) if select is None else select(name, flat)
        kept = mask.mul_(flat)
        comp[name] = kept.view(g.shape).to(g.dtype)
        resid = flat.sub_(kept).view(g.shape)  # acc − kept in f32, before the cast
        del kept
        sq.append(torch.sum(torch.square(resid)))
        r = state.residual[name]
        r.copy_(resid if ok is None else torch.where(ok, resid, r))
    norm = torch.sqrt(sum(sq)) if sq else torch.zeros(())
    return comp, state, {"ef_residual_norm": norm}


def compression_ratio_topk(params: dict, cfg: TopKConfig) -> float:
    """Communicated floats over dense floats (an index counts as one float)."""
    sizes = [p.numel() for p in params.values() if _is_float(p)]
    return sum(2 * n_kept(n, cfg.ratio) for n in sizes) / sum(sizes)


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_dim: int = 128  # leaves smaller than min_dim² entries stay uncompressed


@dataclasses.dataclass
class PowerSGDState:
    q: dict  # {name: (cols, rank) f32}, only for the compressed leaves
    residual: dict  # {name: f32 tensor}, one per floating parameter


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    return g.reshape(g.shape[0], -1) if g.ndim > 1 else g.reshape(1, -1)


def _compressed(p: torch.Tensor, cfg: PowerSGDConfig) -> bool:
    return _is_float(p) and p.ndim >= 2 and p.numel() >= cfg.min_dim**2


def powersgd_init(params: dict, cfg: PowerSGDConfig, *, generator: torch.Generator | None = None,
                  q: dict | None = None) -> PowerSGDState:
    """Zero residuals, and standard normal ``Q (cols, rank)`` for each
    leaf large enough to compress, drawn from ``generator`` (on the CPU,
    moved to the leaf's device) in the parameters' order unless ``q``
    gives it (the reference draws with ``jax.random``; tests pass its Q)."""
    q = dict(q or {})
    out = {}
    for k, p in params.items():
        if not _compressed(p, cfg):
            continue
        cols = _as_matrix(p).shape[1]
        qk = q[k] if k in q else torch.randn((cols, cfg.rank), generator=generator, dtype=torch.float32)
        out[k] = torch.as_tensor(qk, dtype=torch.float32).to(p.device)
    residual = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items() if _is_float(p)}
    return PowerSGDState(out, residual)


def powersgd_compress(cfg: PowerSGDConfig, grads: dict, state: PowerSGDState) -> tuple[dict, PowerSGDState, dict]:
    """``(compressed grads, state, {})``: per compressed leaf ``M = g + r``,
    ``P = qr(M Q)``, ``Q ← Mᵀ P``, the update ``P Qᵀ`` and the residual
    ``M − P Qᵀ``; ``state`` updated in place.
    QR's column signs may differ from the reference's LAPACK, which flips
    P and Q together and leaves ``P Qᵀ`` as it is."""
    comp = {}
    for name, g in grads.items():
        q = state.q.get(name)
        if q is None or not _is_float(g):
            comp[name] = g
            continue
        m = _as_matrix(g.float() + state.residual[name])
        p_fac, _ = torch.linalg.qr(m @ q)
        q_new = m.T @ p_fac
        approx = p_fac @ q_new.T
        comp[name] = approx.reshape(g.shape).to(g.dtype)
        state.residual[name].copy_((m - approx).reshape(g.shape))
        q.copy_(q_new)
    return comp, state, {}
