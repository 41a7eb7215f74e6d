"""The kernels as operators of PyTorch's dispatcher, namespace
``repro_torch``: ``chain_matmul`` (K1, K4 with ``scales``), ``chain_dgrad``
(K2, K5-dgrad), ``chain_wgrad`` (K3, K5-wgrad) and ``bsr_matmul`` (K6).

Each kernel module defines its operator with :func:`define`:

* the **CUDA** implementation is the kernel's launch through ctypes, as
  the wrapper made it before (the wrapper checks its arguments, then calls
  the operator);
* the **CPU** implementation is the plain version;
* the **fake** implementation gives the output's shape and dtype only, so
  a rank's step runs on fake tensors (``launch/dryrun.py``);
* the **flop formula** (:func:`torch.utils.flop_counter.register_flop_formula`)
  is the cost model's (:func:`repro_torch.api.dispatch.chain_flops`), so
  ``FlopCounterMode`` counts one config the same on the CPU's plain path,
  the card's kernels and fake tensors, whatever plain path runs.

A wrapper goes through its operator only while a ``TorchDispatchMode`` is
active (:func:`dispatching`: ``FlopCounterMode``, ``FakeTensorMode``,
``launch/step_cost.py``'s ``StepCost``), the modes that must see the
kernel as one operator; otherwise it calls the implementation itself, as
before the operators existed.  Through the dispatcher a call cost 5–34 µs
more of host time on the H100's host (``dgrad_probe.py``'s ``host_us``,
PERF.md §6), a large share of a serving-batch apply.  Registered
through :class:`torch.library.Library` rather than
``torch.library.custom_op``: no Python layer of argument binding or
autograd around each call.  The operators have no autograd kernel;
``kernels/ops.py``'s autograd Functions call them and are the derivative.
A :class:`~repro_torch.core.compress.ChainPlan` is no dispatcher type, so
an operator takes the plan's integer id (:func:`plan_id`) where the
implementations take the plan.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "DEF")
# operator name -> (kernel without scales, kernel with scales)
KERNELS = {}
_PLANS: list = []
_PLAN_IDS: dict = {}
_LOCK = threading.Lock()


def plan_id(plan) -> int:
    """The integer an operator takes for ``plan`` (one per distinct plan
    for the life of the process)."""
    pid = _PLAN_IDS.get(plan)
    if pid is None:
        with _LOCK:
            pid = _PLAN_IDS.setdefault(plan, len(_PLANS))
            if pid == len(_PLANS):
                _PLANS.append(plan)
    return pid


def plan_of(pid: int):
    return _PLANS[pid]


def dispatching() -> bool:
    """Whether a ``TorchDispatchMode`` is active: a wrapper then calls its
    operator (module docstring)."""
    return torch._C._len_torch_dispatch_stack() > 0


def by_plan(fn):
    """``fn(..., plan, bt)`` as an operator implementation, which takes the
    plan's id: ``(..., pid, bt)``."""
    return lambda *args: fn(*args[:-2], plan_of(args[-2]), args[-1])


def define(name: str, schema: str, *, kernels: tuple[str, str], cpu, cuda, fake, flops):
    """Define ``repro_torch::name`` with ``schema`` and its CPU, CUDA and
    fake implementations and flop formula; returns the operator."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    packet = getattr(torch.ops.repro_torch, name)
    torch.library.register_fake(packet.default, fake, lib=LIB)
    register_flop_formula(packet)(flops)
    op = packet.default
    KERNELS[name] = kernels
    return op


def kernel_name(op, args) -> str | None:
    """The kernel (``"K1"`` … ``"K6"``) an operator call of this library
    runs: the scaled form where its ``scales`` argument is given."""
    if getattr(op, "namespace", None) != "repro_torch":
        return None
    plain, scaled = KERNELS[op._opname]
    scales = {"chain_matmul": 3, "chain_dgrad": 3, "chain_wgrad": 4}.get(op._opname)
    return scaled if scales is not None and args[scales] is not None else plain


def faking() -> bool:
    """Whether a ``FakeTensorMode`` is active (a dry run): the kernels'
    table caches neither keep nor hand out tensors then."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
