"""Operator API: :class:`FaustOp` and its combinators, ``factorize``, and
backend dispatch with the measured table on top (``autotune``)."""
from repro_torch.api import autotune
from repro_torch.api.dispatch import DispatchReport, choose_backend, last_report
from repro_torch.api.factorize import FactorizeInfo, FactorizeSpec, TargetPrep, factorize
from repro_torch.api.operator import FaustOp, block_diag, hstack, vstack

__all__ = [
    "DispatchReport",
    "FactorizeInfo",
    "FactorizeSpec",
    "FaustOp",
    "TargetPrep",
    "autotune",
    "block_diag",
    "choose_backend",
    "factorize",
    "hstack",
    "last_report",
    "vstack",
]
