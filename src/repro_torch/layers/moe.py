"""Mixture-of-Experts FFN: top-k routing with per-group capacity dispatch.
Counterpart of :mod:`repro.layers.moe` (``MoESpec``, ``moe_init``,
``capacity_per_group``, ``route``, ``moe_apply``).

Tokens are grouped by the leading batch dim: each group (row) routes its
own tokens into a per-group expert buffer of static capacity ``C``, and the
expert compute is one einsum over ``(groups, experts, C, d)``.  Overflow
is dropped (its slot index is the pad slot ``E·C``, which reads a zero
row) and underfull slots read the zero pad row: the GShard/Switch
capacity semantics.  The reference computes all of this outside any
Pallas kernel, so here it is plain PyTorch.

Bits that follow the reference exactly: ``lax.top_k``'s order (a stable
descending sort: ties go to the lowest expert index), a stable argsort of
the flat expert ids, the router in f32 (its parameter is f32 in any model
dtype, the logits are ``x.float() @ router``), and the routing weights
cast to ``x``'s dtype before the sum over k.

Supports top-1 (llama4-maverick) and top-k (granite top-8), an optional
shared expert (llama4) and the Switch load-balancing loss.

On a mesh a rank may compute its block of the layer (a :class:`MoESplit`
of ``models/lm.py`` ``split_plan``): its experts whole (expert
parallelism, the reference's ``experts`` on ``experts_act``), or every
expert's block of hidden columns (where the experts stay replicated and
their ``mlp`` lies on ``mlp_act``).  Routing stays whole on every rank:
the router is read whole, so the slots, the weights and every dropped
token are the unsplit layer's, and no token crosses ranks.  The rank
returns its partial output (:func:`moe_apply` with ``split``); the caller
sums it over the split and adds the shared expert once
(``models/lm.py`` ``Layer``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.layers.embedding import dense_param
from repro_torch.layers.mlp import GLU_KINDS, MLP, _act


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int
    act: str = "swiglu"
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0  # 0: no shared expert
    router_aux_coef: float = 0.01


def capacity_per_group(tokens_per_group: int, spec: MoESpec) -> int:
    return max(math.ceil(tokens_per_group * spec.top_k / spec.n_experts * spec.capacity_factor), 1)


class Routing(NamedTuple):
    slot_src: torch.Tensor  # (G, E·C) source token of each expert slot (T ⇒ the pad row)
    dest: torch.Tensor  # (G, T·k) slot of each (token, k) pair (E·C ⇒ dropped)
    weights: torch.Tensor  # (G, T, k) routing weights, renormalized over k
    aux_loss: torch.Tensor  # scalar load-balancing loss (before router_aux_coef)


def top_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` experts of largest probability, ``(..., k)``, in
    ``lax.top_k``'s order (a stable descending sort: ties go to the lowest
    expert index)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def route(logits: torch.Tensor, spec: MoESpec) -> Routing:
    """Routing of grouped tokens, ``logits (G, T, E)``."""
    g, t, e = logits.shape
    k = spec.top_k
    c = capacity_per_group(t, spec)
    probs = torch.softmax(logits.float(), dim=-1)
    top_e = top_experts(probs, k)
    top_w = torch.gather(probs, -1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(g, t * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices  # (G, T·k)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=logits.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts  # (G, E)
    pos_in_e = torch.arange(t * k, device=logits.device)[None, :] - torch.gather(offsets, 1, sorted_e)
    dest_sorted = torch.where(pos_in_e < c, sorted_e * c + pos_in_e, e * c)
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)  # back to (token, k) order
    # slot → source token; every dropped pair lands in the pad slot E·C, cut off after
    slot_src = torch.full((g, e * c + 1), t, dtype=torch.int64, device=logits.device)
    slot_src.scatter_(1, dest_sorted, torch.div(order, k, rounding_mode="floor"))

    # Switch load-balancing loss: E · mean over groups of Σ_e f_e · P_e
    dispatch_frac = counts.float() / (t * k)
    prob_frac = probs.mean(dim=1)
    aux = spec.n_experts * torch.mean(torch.sum(dispatch_frac * prob_frac, dim=-1))
    return Routing(slot_src[:, :e * c], dest, top_w, aux)


@dataclasses.dataclass(frozen=True)
class MoESplit:
    """What a rank computes of a MoE layer split over the axes of ``tp``
    (a :class:`~repro_torch.distributed.layout.TPSplit`): the ``experts``
    experts from ``expert_lo`` (fewer than all: expert parallel) and, of
    each, the ``ff`` hidden columns from ``ff_lo`` (fewer than the
    expert's width: the width split; ``w_up``/``w_gate``'s columns,
    ``w_down``'s rows)."""

    tp: object
    experts: int
    expert_lo: int
    ff: int
    ff_lo: int


class MoE(nn.Module):
    """``router (d, E)`` in f32; ``w_up``/``w_gate (E, d, ff)`` and
    ``w_down (E, ff, d)`` in the model's dtype; ``shared``, a dense
    :class:`MLP`, when ``spec.shared_expert_ff`` is set.

    The expert weights are drawn in their own dtype and scaled in place,
    so no f32 or second temporary of their size exists (llama4-maverick's
    three are 32 GB in bf16)."""

    def __init__(self, d_model: int, spec: MoESpec, *, generator, dtype, device):
        super().__init__()
        self.spec = spec
        e, ff = spec.n_experts, spec.d_ff
        self.router = dense_param(d_model, e, generator=generator, dtype=torch.float32, device=device)

        def experts(shape, std):
            w = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
            return nn.Parameter(w.mul_(std).to(device))

        self.w_up = experts((e, d_model, ff), 1.0 / math.sqrt(d_model))
        self.w_down = experts((e, ff, d_model), 1.0 / math.sqrt(ff))
        if spec.act in GLU_KINDS:
            self.w_gate = experts((e, d_model, ff), 1.0 / math.sqrt(d_model))
        if spec.shared_expert_ff:
            self.shared = MLP(d_model, spec.shared_expert_ff, spec.act, generator=generator, dtype=dtype,
                              device=device)

    def forward(self, x: torch.Tensor, split: MoESplit | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``x (B, S, d)``, B the group dim: ``(y, aux · router_aux_coef)``
        (:func:`moe_apply`)."""
        return moe_apply(self, x, self.spec, split)


def moe_apply(p: MoE, x: torch.Tensor, spec: MoESpec, split: MoESplit | None = None):
    """``(y, aux · router_aux_coef)`` of ``x (B, S, d)``.  With ``split``
    the rank's part: the same routing, the rank's experts' slots
    ``slot_src[:, lo·C:(lo+n)·C]`` through its experts (a ``(token, k)``
    pair whose slot lies outside them reads the zero pad row), or every
    slot through its hidden columns (each product with ``w_down`` a
    partial sum); ``y`` is the rank's partial output without the shared
    expert, summed over ``k`` in f32 (each term rounded as the unsplit
    layer rounds it; the caller rounds the sum over the split once)."""
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    c = capacity_per_group(s, spec)
    r = route(x.float() @ p.router, spec)
    lo, el = (0, e) if split is None else (split.expert_lo, split.experts)
    src = r.slot_src if el == e else r.slot_src[:, lo * c:(lo + el) * c]

    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)  # the pad row
    xe = torch.take_along_dim(x_pad, src[..., None], dim=1).reshape(b, el, c, d)
    up = torch.einsum("becd,edf->becf", xe, p.w_up)
    if spec.act in GLU_KINDS:
        h = _act(spec.act, torch.einsum("becd,edf->becf", xe, p.w_gate)) * up
    else:
        h = _act(spec.act, up)
    ye = torch.einsum("becf,efd->becd", h, p.w_down)  # (B, E, C, d)

    # combine: each (token, k) pair reads its slot (a dropped one, or one of
    # another rank's experts, the zero pad row)
    dest = r.dest
    if el != e:
        local = dest - lo * c
        dest = torch.where((local >= 0) & (local < el * c), local, el * c)
    ye_pad = torch.cat([ye.reshape(b, el * c, d), ye.new_zeros((b, 1, d))], dim=1)
    contrib = torch.take_along_dim(ye_pad, dest[..., None], dim=1)  # (B, S·k, d)
    contrib = contrib.reshape(b, s, k, d) * r.weights[..., None].to(x.dtype)
    aux = r.aux_loss * spec.router_aux_coef
    if split is not None:
        return contrib.sum(dim=2, dtype=torch.float32), aux
    y = contrib.sum(dim=2)
    if spec.shared_expert_ff:
        y = y + p.shared(x)
    return y, aux
