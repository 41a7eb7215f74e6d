"""Streaming factorization: online PALM4MSA tracking of drifting targets
and guarded hot-swap of the refreshed operator into the serving runtime.
Counterpart of :mod:`repro.streaming`.

* :mod:`repro_torch.streaming.online` — :class:`StreamingFaust`: warm
  mini-sweeps against each new target snapshot, a sketched drift monitor,
  and a budget controller choosing skip / incremental sweep / full
  hierarchical refactorization per step.
* :mod:`repro_torch.streaming.swap` — operator hot-swap into the serving
  runtime between decode steps (values-only or staged re-pack, with an
  optional sketched guard).
"""
from repro_torch.streaming.online import StreamingConfig, StreamingFaust, UpdateRecord
from repro_torch.streaming.swap import SwapReport, classify_swap, hot_swap

__all__ = [
    "StreamingConfig",
    "StreamingFaust",
    "UpdateRecord",
    "SwapReport",
    "classify_swap",
    "hot_swap",
]
