"""What one rank's step costs, counted op by op as it runs.  Counterpart
of :func:`repro.launch.hlo_cost.hlo_cost` (and of the collective parse in
``repro.launch.roofline``): the reference reads optimized HLO text; eager
PyTorch has none, so :class:`StepCost`, a ``TorchDispatchMode``, counts
every operator the step dispatches, on real tensors or on fake ones
(``launch/dryrun.py``).

* **flops**: torch's flop-formula registry for matmuls and convolutions
  (``torch.utils.flop_counter``, which holds the kernels' own formula:
  ``kernels/library.py``), plus ``|result|`` for an elementwise operator
  and ``|operand|`` for a reduction: ``hlo_cost``'s rules.  ``matmul_flops``
  is the registry's part alone, what ``FlopCounterMode`` counts.
* **bytes**: each eager operator is a launch, so operands plus result,
  except: views, reshapes, allocations and metadata are free; a slice or
  index read counts twice its result; an in-place write into part of a
  tensor counts twice the part (``hlo_cost``'s dynamic-slice and
  dynamic-update-slice rules).
* **peak live bytes**: the storages the step's operators create (not a
  view's, not an in-place result's), each counted from its creation until
  it is freed, over what lived before (:attr:`StepCost.base_bytes`, the
  caller's); the largest sum is the peak.
* **launches** of the kernels K1–K6 (``kernels/library.py``), and their
  flops by kernel;
* **collectives**: bytes of every ``c10d`` call's result by operator
  (all-gather, reduce-scatter, all-reduce, broadcast), and the model's own
  count by purpose (``distributed/layout.py``), taken around the step.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import layout
from repro_torch.kernels import library

# reductions: |operand| flops
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "argmax", "argmin", "any", "all", "cumsum", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "topk", "sort",
}
# reads of part of a tensor: 2 × result bytes
_READ_PART = {"index", "index_select", "gather", "embedding", "take_along_dim"}
# writes into part of a tensor, and the argument holding the part
_WRITE_PART = {"index_put_": 2, "index_put": 2, "index_copy_": 3, "index_add_": 3, "scatter_": 3,
               "scatter_add_": 3, "copy_": 1}
# free: no data moves (allocations, metadata, aliasing)
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias", "lift_fresh",
    "_unsafe_view", "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "_local_scalar_dense", "device",
    "_to_copy_meta", "record_stream",
}
# c10d operators: (result-bearing argument, reported kind)
_C10D = {
    "allgather_": (0, "all-gather"), "_allgather_base_": (0, "all-gather"),
    "allgather_into_tensor_coalesced_": (0, "all-gather"),
    "reduce_scatter_": (0, "reduce-scatter"), "_reduce_scatter_base_": (0, "reduce-scatter"),
    "reduce_scatter_tensor_coalesced_": (0, "reduce-scatter"),
    "allreduce_": (0, "all-reduce"), "allreduce_coalesced_": (0, "all-reduce"), "broadcast_": (0, "broadcast"),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


class StepCost(TorchDispatchMode):
    """Counts what the operators dispatched inside it cost (module
    docstring); read :meth:`record` after the step."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.kernel_flops: collections.Counter = collections.Counter()
        self.launches: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_count: collections.Counter = collections.Counter()
        self.base_bytes = base_bytes
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._before = None

    def __enter__(self):
        self._before = ({k: v for k, v in layout.COLLECTIVES.items()}, {k: v for k, v in layout.BYTES.items()})
        return super().__enter__()

    def __exit__(self, *exc):
        calls, moved = self._before
        self.by_purpose = {k: {"count": layout.COLLECTIVES[k] - calls[k], "bytes": layout.BYTES[k] - moved[k]}
                           for k in layout.COLLECTIVES if layout.COLLECTIVES[k] != calls[k]}
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if all(r.alias_info is None for r in func._schema.returns):  # not a view, not in place
            self._track(out)
        return out

    # -- live storages ---------------------------------------------------------
    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- flops, bytes, launches, collectives -----------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        ns, name = func.namespace, packet.__name__
        if ns == "c10d":
            arg, kind = _C10D.get(name, (0, name))
            self.coll_bytes[kind] += _nbytes(args[arg])
            self.coll_count[kind] += 1
            self.bytes += _nbytes(args) + _nbytes(out)
            return
        kernel = library.kernel_name(func, args)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.matmul_flops += f
            if kernel is not None:
                self.kernel_flops[kernel] += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += _numel(out)
        elif name in _REDUCE:
            self.flops += _numel(args[0])
        if kernel is not None:
            self.launches[kernel] += 1
        if func.is_view or name in _FREE or not any(True for _ in _tensors(out)) and name not in _WRITE_PART:
            return
        if name in _READ_PART:
            self.bytes += 2 * _nbytes(out)
        elif name in _WRITE_PART:
            self.bytes += 2 * _nbytes(args[_WRITE_PART[name]] if len(args) > _WRITE_PART[name] else out)
        else:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) + _nbytes(out)

    def record(self) -> dict:
        """The counts as the dry run's record keeps them."""
        return {
            "cost": {"flops": self.flops, "bytes": self.bytes, "matmul_flops": self.matmul_flops,
                     "kernel_flops": dict(sorted(self.kernel_flops.items()))},
            "launches": dict(sorted(self.launches.items())),
            "peak_live_bytes": self.base_bytes + self.peak,
            "counted": {"by_op": dict(self.coll_bytes), "count": dict(self.coll_count),
                        "by_purpose": getattr(self, "by_purpose", {})},
        }
