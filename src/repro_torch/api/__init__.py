"""Operator API: :class:`FaustOp`, ``factorize`` and backend dispatch."""
from repro_torch.api.dispatch import DispatchReport, choose_backend, last_report
from repro_torch.api.factorize import FactorizeInfo, FactorizeSpec, factorize
from repro_torch.api.operator import FaustOp

__all__ = [
    "DispatchReport",
    "FactorizeInfo",
    "FactorizeSpec",
    "FaustOp",
    "choose_backend",
    "factorize",
    "last_report",
]
