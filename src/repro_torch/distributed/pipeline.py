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

The backward (the reference differentiates its ``shard_map`` under
``jax.grad``) is the whole schedule as one autograd function, so every
rank shifts exactly once a tick in both directions: the forward keeps each
tick's stage input (GPipe's activation stash), and the backward runs the
ticks in reverse.  At tick ``t`` the cotangent of the stage's output is
what stage ``i + 1`` sent back, plus, on the last stage, the cotangent of
the microbatch it emitted; the stage's vector-Jacobian product comes from
``stage_fn`` run again under autograd on the stashed input; the cotangent
of its input goes to stage ``i − 1`` (stage 0 sends zeros: its input was
the injected microbatch, whose cotangent is ``dx``'s, sent from stage 0
to every pod rank at the end).  A tick where the stage holds no
microbatch (the fill and the drain) has a zero cotangent and runs no
product.  The broadcast's backward is the last stage's
cotangent alone, not a sum over the pod ranks: a loss computed the same
way on every rank gets the sequential walk's gradient.  Parameter
gradients land in the rank's own stage row of ``stage_params`` (zeros in
the others).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as _mesh


def _shift(t: torch.Tensor, group, n: int, idx: int, step: int = 1) -> torch.Tensor:
    """Stage ``idx``'s ``t`` sent to stage ``idx + step`` and stage
    ``idx − step``'s received (mod ``n``), over ``group``, bit for bit."""
    wire = _mesh._as_wire(t, group)
    send = _mesh._bits(wire)
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, (idx + step) % n)
    frm = dist.get_global_rank(group, (idx - step) % n)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                       dist.P2POp(dist.irecv, recv, frm, group)]):
        req.wait()
    return (recv.view(t.dtype) if send is not wire else recv).to(t.device)


class _Pipeline(torch.autograd.Function):
    """The schedule, forward and backward (module docstring).  ``names``
    key ``vals``, the stage parameters; ``ctx`` keeps the stashed inputs."""

    @staticmethod
    def forward(ctx, stage_fn, names, mesh, axis, n_micro, x, *vals):
        n_stages = mesh.shape[axis]
        b = x.shape[0]
        xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        stage, group = mesh.coord[axis], mesh.group(axis)
        params = {k: v[stage] for k, v in zip(names, vals)}
        buf = torch.zeros_like(xm[0])
        outs = torch.zeros_like(xm)
        stash = {}
        for t in range(n_micro + n_stages - 1):
            h_in = xm[min(t, n_micro - 1)] if stage == 0 else buf
            if 0 <= t - stage < n_micro:
                stash[t] = h_in
            h_out = stage_fn(params, h_in)
            buf = _shift(h_out, group, n_stages, stage) if n_stages > 1 else h_out
            emit = t - (n_stages - 1)
            if stage == n_stages - 1 and emit >= 0:
                outs[emit] = h_out
        last = dist.get_global_rank(group, n_stages - 1)
        outs = _mesh.broadcast(outs, src=last, group=group)
        ctx.stage_fn, ctx.names, ctx.mesh, ctx.axis, ctx.n_micro = stage_fn, names, mesh, axis, n_micro
        ctx.stash = stash
        ctx.save_for_backward(*vals)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        vals = ctx.saved_tensors
        mesh, axis, n_micro = ctx.mesh, ctx.axis, ctx.n_micro
        n_stages, stage, group = mesh.shape[axis], mesh.coord[axis], mesh.group(axis)
        gm = gy.reshape(n_micro, -1, *gy.shape[1:])
        grads = [torch.zeros_like(v) if v.is_floating_point() else None for v in vals]
        mine = {k: v[stage].detach().requires_grad_(v.is_floating_point()) for k, v in zip(ctx.names, vals)}
        wrt = [mine[k] for k, v in zip(ctx.names, vals) if v.is_floating_point()]
        dx = torch.zeros_like(gm) if ctx.needs_input_grad[5] else None
        g_next = torch.zeros_like(gm[0])  # the cotangent stage i + 1 sent back
        for t in reversed(range(n_micro + n_stages - 1)):
            g_out = g_next
            emit = t - (n_stages - 1)
            if stage == n_stages - 1 and emit >= 0:
                g_out = g_out + gm[emit]
            g_in = torch.zeros_like(g_out)
            if t in ctx.stash:
                with torch.enable_grad():
                    h = ctx.stash[t].detach().requires_grad_()
                    d = torch.autograd.grad(ctx.stage_fn(mine, h), [h, *wrt], g_out, allow_unused=True)
                g_in = d[0]
                for gv, dv in zip((g for g in grads if g is not None), d[1:]):
                    if dv is not None:
                        gv[stage] += dv
            if stage == 0:
                if dx is not None:
                    dx[min(t, n_micro - 1)] += g_in
                g_in = torch.zeros_like(g_in)
            if t and n_stages > 1:
                g_next = _shift(g_in, group, n_stages, stage, step=-1)
        ctx.stash = None
        if dx is not None:  # x is the same on every rank, and so is its gradient
            dx = _mesh.broadcast(dx, src=dist.get_global_rank(group, 0), group=group)
        return (None, None, None, None, None, None if dx is None else dx.reshape(gy.shape), *grads)


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor, *, mesh, axis: str = "pod",
                   n_microbatches: int) -> torch.Tensor:
    """``y = stage_{S-1}(…stage_0(x))`` pipelined over ``axis`` of ``mesh``,
    differentiable (module docstring).

    ``stage_params``: a dict of tensors with a leading ``n_stages`` dim
    (every rank holds all stages; a rank reads its own, ``mesh.coord
    [axis]``); ``stage_fn(params, h) -> h`` applies one stage.  ``x``
    ``(batch, ...)``, the same on every rank, its batch a multiple of
    ``n_microbatches``.  Returns ``y`` with ``x``'s shape on every rank."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"a batch of {b} does not split into {n_microbatches} microbatches")
    names = tuple(stage_params)
    return _Pipeline.apply(stage_fn, names, mesh, axis, n_microbatches, x, *(stage_params[k] for k in names))


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
