"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].
Counterpart of :mod:`repro.layers.mamba2` (``Mamba2Spec``,
``mamba2_init``, ``MambaCache``, ``mamba_cache_init``, ``_causal_conv``,
``_segsum``, ``ssd_chunked``, ``_ssd_interchunk``, ``mamba2_apply``).

Training and prefill run the chunked SSD: within a chunk of ``T`` tokens
the terms are attention-like ``(T, T)`` products; across chunks an
``(H, P, N)`` state passes through a loop over the chunks (the
reference's ``lax.scan``).  Decode keeps the O(1) recurrent state.
Plain PyTorch: the reference has no Pallas kernel here.

Layout: ``d_inner = expand·d_model``, ``H`` heads of ``P = headdim``,
``G`` groups sharing ``B``/``C`` (head ``h`` reads group ``h // (H/G)``),
``N = d_state``.  The reference's rounding points are kept: in a bf16
model ``C·Bᵀ`` rounds to bf16 before it meets the f32 decay, ``x·dt``,
the chunk states and ``y`` are f32 until ``y`` is cast back, decode runs
its recurrence in f32, and ``a_log``, ``d_skip`` and ``dt_bias`` stay f32.
The reference repeats ``C·Bᵀ`` and ``B``/``C`` over each group's heads;
here the heads are viewed as ``(G, H/G)`` and broadcast instead, which
multiplies the same values without the copies.

Split over the heads (:class:`SSMSplit`: under a policy whose
``heads_act`` names the axes ``inner_flat`` lies on in training, and on
the axes a ``MambaCache``'s heads lie on in serving): a rank computes its
``H/n`` heads.  It reads its columns of ``z``, ``x`` and ``dt`` and its
heads' groups' ``B`` and ``C`` from the whole ``in_proj`` (whose columns
``[z | x | B | C | dt]`` its blocks cut elsewhere), the same channels of
the conv, its heads' ``a_log``/``d_skip``/``dt_bias``; it runs the conv
and the SSD on them, normalizes its block of ``y·silu(z)`` by the mean of
squares over the whole ``d_inner`` (``norms.rmsnorm(split=)``), and
projects through its rows of ``out_proj``, the partial outputs summed in
f32 over the split (``TPSplit.project(f32_sum=True)``).  Its
``MambaCache`` holds those heads' state and those conv channels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.layers.embedding import dense_param
from repro_torch.layers.norms import rmsnorm


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.headdim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of headdim {self.headdim}")
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class SSMSplit:
    """A rank's heads (module docstring): the split ``tp`` (a
    :class:`~repro_torch.distributed.layout.TPSplit`), its ``heads``
    heads from ``head_lo``, and the ``groups`` state groups from
    ``group_lo`` that they read."""

    tp: object
    heads: int
    head_lo: int
    groups: int
    group_lo: int

    def in_columns(self, spec: Mamba2Spec) -> list[tuple[int, int]]:
        """``(start, width)`` in ``in_proj`` of the rank's ``z``, ``x``,
        ``B``, ``C`` and ``dt`` columns."""
        di, gn, p, n = spec.d_inner, spec.n_groups * spec.d_state, spec.headdim, spec.d_state
        h0, hw = self.head_lo * p, self.heads * p
        g0, gw = self.group_lo * n, self.groups * n
        return [(h0, hw), (di + h0, hw), (2 * di + g0, gw), (2 * di + gn + g0, gw),
                (2 * di + 2 * gn + self.head_lo, self.heads)]

    def conv_dim(self, spec: Mamba2Spec) -> int:
        """The rank's conv channels: its heads' ``x`` and its groups' ``B`` and ``C``."""
        return self.heads * spec.headdim + 2 * self.groups * spec.d_state


class Mamba2(nn.Module):
    """The block's parameters: ``in_proj (d, 2·d_inner + 2·G·N + H)``,
    ``conv_w (d_conv, conv_dim)``, ``conv_b``, ``a_log``/``d_skip``/
    ``dt_bias (H,)`` in f32, ``norm_w (d_inner,)``, ``out_proj (d_inner,
    d)``; drawn as the reference's ``mamba2_init``.  Applied by
    :func:`mamba2_apply`."""

    def __init__(self, spec: Mamba2Spec, *, generator, dtype, device):
        super().__init__()
        self.spec = spec
        d, h = spec.d_model, spec.n_heads
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.in_proj = dense_param(d, 2 * spec.d_inner + 2 * spec.n_groups * spec.d_state + h, **kw)
        gdev = generator.device
        conv_w = torch.randn((spec.d_conv, spec.conv_dim), generator=generator, device=gdev) / math.sqrt(spec.d_conv)
        self.conv_w = nn.Parameter(conv_w.to(device=device, dtype=dtype))
        self.conv_b = nn.Parameter(torch.zeros((spec.conv_dim,), dtype=dtype, device=device))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h, device=device)))
        self.d_skip = nn.Parameter(torch.ones((h,), device=device))
        u = torch.rand((h,), generator=generator, device=gdev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        self.dt_bias = nn.Parameter((dt + torch.log(-torch.expm1(-dt))).to(device))  # inverse softplus
        self.norm_w = nn.Parameter(torch.zeros((spec.d_inner,), dtype=dtype, device=device))
        self.out_proj = dense_param(spec.d_inner, d, **kw)


class MambaCache(NamedTuple):
    """A mamba layer's serving state: ``conv (B, d_conv − 1, conv_dim)``,
    the last inputs of the causal conv in the activations' dtype; ``ssm
    (B, H, P, N)``, the f32 recurrent state; ``pos (B,)`` int32, the tokens
    each row has seen.  On a split (:class:`SSMSplit`) the rank's: its
    ``H/n`` heads' state and its :meth:`SSMSplit.conv_dim` channels."""

    conv: torch.Tensor
    ssm: torch.Tensor
    pos: torch.Tensor


def mamba_cache_init(b: int, spec: Mamba2Spec, dtype=torch.bfloat16, device=None,
                     split: SSMSplit | None = None) -> MambaCache:
    conv, heads = (spec.conv_dim, spec.n_heads) if split is None else (split.conv_dim(spec), split.heads)
    return MambaCache(
        torch.zeros((b, spec.d_conv - 1, conv), dtype=dtype, device=device),
        torch.zeros((b, heads, spec.headdim, spec.d_state), dtype=torch.float32, device=device),
        torch.zeros((b,), dtype=torch.int32, device=device),
    )


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence: ``x (B,S,C)``, ``w (K,C)``;
    ``prev (B,K−1,C)`` is the history before ``x`` (decode), zeros when
    None.  The ``K`` products are summed in order, in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Cumulative log-decay matrix ``L[i, j] = Σ_{j<t≤i} log_a[t]``, −inf
    above the diagonal: ``log_a (..., T)`` → ``(..., T, T)``."""
    t = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_: torch.Tensor,
    c: torch.Tensor,
    chunk: int,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD of ``x (B,S,H,P)``, ``dt (B,S,H)`` f32 (after softplus),
    ``a (H,)`` f32 (negative), ``b_``/``c (B,S,G,N)``: ``(y (B,S,H,P) f32,
    final state (B,H,P,N) f32)``.  A sequence longer than ``chunk`` must be
    a multiple of it, as in the reference."""
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {chunk}")
    nc, rep = s // chunk, h // g
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_.reshape(bsz, nc, chunk, g, n)
    cc = c.reshape(bsz, nc, chunk, g, n)

    log_a = dtc * a  # (B,nc,T,H), ≤ 0
    # intra-chunk (attention-like) term
    lmat = torch.exp(segsum(log_a.transpose(2, 3)))  # (B,nc,H,T,T)
    cb = torch.einsum("bctgn,bcsgn->bcgts", cc, bc)  # (B,nc,G,T,T), in the activations' dtype
    w = (cb[:, :, :, None] * lmat.view(bsz, nc, g, rep, chunk, chunk)).view(bsz, nc, h, chunk, chunk)
    xdt = xc * dtc[..., None]  # (B,nc,T,H,P) f32
    y_intra = torch.einsum("bchts,bcshp->bcthp", w, xdt)

    cum = torch.cumsum(log_a, dim=2)  # (B,nc,T,H)
    total = cum[:, :, -1:]  # (B,nc,1,H)
    return _ssd_interchunk(y_intra, xdt, bc, cc, cum, total, init_state)


def _ssd_interchunk(y_intra, xdt, bc, cc, cum, total, init_state):
    """The state passed across chunks and its output term."""
    bsz, nc, chunk, h, p = xdt.shape
    g, n = bc.shape[3], bc.shape[4]
    rep = h // g
    # chunk state: Σ_t B_t ⊗ (x_t·dt_t) · decay(t → end)
    decay_to_end = torch.exp(total - cum)  # (B,nc,T,H)
    xg = (xdt * decay_to_end[..., None]).view(bsz, nc, chunk, g, rep, p)
    states = torch.einsum("bctgn,bctgrp->bcgrpn", bc.float(), xg).reshape(bsz, nc, h, p, n)
    chunk_decay = torch.exp(total[:, :, 0])  # (B,nc,H): decay across a whole chunk
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xdt.device) if init_state is None
             else init_state.float())
    entering = []  # the state entering each chunk
    for i in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    prev = torch.stack(entering, dim=1).view(bsz, nc, g, rep, p, n)
    # inter-chunk output: C_t · decay(start → t) · state entering the chunk
    cd = cc.float()[:, :, :, :, None] * torch.exp(cum).view(bsz, nc, chunk, g, rep)[..., None]  # (B,nc,T,G,R,N)
    y_inter = torch.einsum("bctgrn,bcgrpn->bctgrp", cd, prev).reshape(bsz, nc, chunk, h, p)
    return (y_intra + y_inter).reshape(bsz, nc * chunk, h, p), state


def _rank_params(m: Mamba2, spec: Mamba2Spec, split: SSMSplit | None):
    """``(in_proj, conv_w, conv_b, a_log, d_skip, dt_bias)`` as the rank
    reads them: whole, or its columns, channels and heads of ``split``."""
    if split is None:
        return m.in_proj, m.conv_w, m.conv_b, m.a_log, m.d_skip, m.dt_bias
    cols = split.in_columns(spec)
    conv = [(o - spec.d_inner, w) for o, w in cols[1:4]]  # x, B, C of the conv's [x | B | C]
    heads = slice(split.head_lo, split.head_lo + split.heads)
    return (torch.cat([m.in_proj.narrow(1, o, w) for o, w in cols], dim=1),
            torch.cat([m.conv_w.narrow(1, o, w) for o, w in conv], dim=1),
            torch.cat([m.conv_b.narrow(0, o, w) for o, w in conv]),
            m.a_log[heads], m.d_skip[heads], m.dt_bias[heads])


def mamba2_apply(m: Mamba2, x: torch.Tensor, spec: Mamba2Spec, cache: MambaCache | None = None,
                 decode: bool = False, chunk: int | None = None, split: SSMSplit | None = None):
    """The block on ``x (B,S,d)``: ``(out, new cache)``.  Train: no cache
    (None back).  Prefill: ``cache`` given, returned with the conv history
    and the final state.  Decode (``decode``, ``S == 1``): the recurrent
    update of ``cache``.  ``chunk`` is the SSD chunk (default
    ``spec.chunk``).  ``split``: this rank's heads (module docstring);
    ``m.norm_w`` and ``m.out_proj`` are its block, ``cache`` its state."""
    bsz, s, _ = x.shape
    pd, n = spec.headdim, spec.d_state
    h, g = (spec.n_heads, spec.n_groups) if split is None else (split.heads, split.groups)
    di = h * pd
    if split is not None:
        x = split.tp.enter(x)
    in_proj, conv_w, conv_b, a_log, d_skip, dt_bias = _rank_params(m, spec, split)
    conv_dim = di + 2 * g * n
    z, xbc, dt_raw = torch.split(x @ in_proj, [di, conv_dim, h], dim=-1)
    prev = cache.conv if (cache is not None and decode) else None
    xbc_conv = F.silu(causal_conv(xbc, conv_w, conv_b, prev))
    xs, b_, c = torch.split(xbc_conv, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, h, pd)
    b_ = b_.reshape(bsz, s, g, n)
    c = c.reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + dt_bias)  # (B,S,H) f32
    a = -torch.exp(a_log)  # (H,)

    new_cache = None
    if decode:
        if cache is None or s != 1:
            raise ValueError(f"decode takes one token per row and a cache; got S = {s}, cache {cache is not None}")
        # recurrent update: h' = h·exp(dt·a) + dt·B⊗x; y = C·h' + D·x
        dt1 = dt[:, 0]  # (B,H)
        da = torch.exp(dt1 * a)
        b_h = b_[:, 0].float().repeat_interleave(h // g, dim=1)  # (B,H,N): groups → heads
        c_h = c[:, 0].float().repeat_interleave(h // g, dim=1)
        bx = b_h[:, :, None, :] * (xs[:, 0] * dt1[..., None]).float()[..., None]  # (B,H,P,N)
        ssm = cache.ssm * da[..., None, None] + bx
        y = torch.einsum("bhpn,bhn->bhp", ssm, c_h)
        y = y + d_skip[None, :, None] * xs[:, 0].float()
        y = y.reshape(bsz, 1, di).to(x.dtype)
        conv_hist = torch.cat([cache.conv[:, 1:], xbc.to(cache.conv.dtype)], dim=1)
        new_cache = MambaCache(conv_hist, ssm, cache.pos + 1)
    else:
        y, final_state = ssd_chunked(xs, dt, a, b_, c, spec.chunk if chunk is None else chunk)
        y = y + d_skip[None, None, :, None] * xs
        y = y.reshape(bsz, s, di).to(x.dtype)
        if cache is not None:  # prefill: the conv history and the final state
            k = spec.d_conv - 1
            if s >= k:
                conv_hist = xbc[:, s - k:]
            else:
                conv_hist = torch.cat([torch.zeros((bsz, k - s, conv_dim), dtype=xbc.dtype, device=x.device),
                                       xbc], dim=1)
            new_cache = MambaCache(conv_hist.to(cache.conv.dtype), final_state,
                                   torch.full(cache.pos.shape, s, dtype=torch.int32, device=cache.pos.device))

    if split is None:
        return rmsnorm(m.norm_w, y * F.silu(z)) @ m.out_proj, new_cache
    y = rmsnorm(m.norm_w, y * F.silu(z), split=split.tp)
    return split.tp.project(y, m.out_proj, f32_sum=True), new_cache
