"""Pipeline parallelism over the ``pod`` mesh axis.  Counterpart of
:mod:`repro.distributed.pipeline`.

GPipe fill/drain: each pod rank holds one stage, the batch is cut into
``n_microbatches`` microbatches, and ``n_micro + n_stages − 1`` ticks run
every stage on its current buffer: stage 0 takes microbatch ``t``, stage
``i`` passes its output to stage ``i + 1`` over the pod group (a
point-to-point send and receive; the ring's wraparound is ignored), and
the last stage emits microbatch ``t − (n_stages − 1)`` once the pipe is
full.  Only microbatch-sized activations cross pods.  The result is sent
from the last stage to every pod rank.  Bubble fraction
``(S − 1) / (M + S − 1)``.

The reference's only caller is its test; the forward is the contract, so
this runs under ``no_grad`` (no backward schedule).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as _mesh


def _shift(t: torch.Tensor, group, n: int, idx: int) -> torch.Tensor:
    """Stage ``idx``'s ``t`` sent to stage ``idx + 1`` and stage ``idx − 1``'s
    received (mod ``n``), over ``group``, bit for bit."""
    wire = _mesh._as_wire(t, group)
    send = _mesh._bits(wire)
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                       dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()
    return (recv.view(t.dtype) if send is not wire else recv).to(t.device)


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor, *, mesh, axis: str = "pod",
                   n_microbatches: int) -> torch.Tensor:
    """``y = stage_{S-1}(…stage_0(x))`` pipelined over ``axis`` of ``mesh``.

    ``stage_params``: a dict of tensors with a leading ``n_stages`` dim
    (every rank may hold all stages; a rank reads its own, ``mesh.coord
    [axis]``); ``stage_fn(params, h) -> h`` applies one stage.  ``x``
    ``(batch, ...)``, the same on every rank, its batch a multiple of
    ``n_microbatches``.  Returns ``y`` with ``x``'s shape on every rank."""
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"a batch of {b} does not split into {n_microbatches} microbatches")
    xm = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    stage = mesh.coord[axis]
    group = mesh.group(axis)
    params = {k: v[stage] for k, v in stage_params.items()}
    buf = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(n_microbatches + n_stages - 1):
        h_in = xm[min(t, n_microbatches - 1)] if stage == 0 else buf
        h_out = stage_fn(params, h_in)
        buf = _shift(h_out, group, n_stages, stage) if n_stages > 1 else h_out
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and emit >= 0:
            outs[emit] = h_out
    last = dist.get_global_rank(group, n_stages - 1)
    outs = _mesh.broadcast(outs, src=last, group=group)
    return outs.reshape(b, *x.shape[1:])


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
