"""Cost-model backend dispatch for :class:`repro_torch.api.operator.FaustOp`.
Counterpart of :mod:`repro.api.dispatch` (forward pricing).

    t(backend) ≈ max(flops / PEAK_FLOPS, bytes / HBM_BW) + launches·t_launch

* ``dense``: build the matrix (≈ 2·s_tot·min(m,n) flops, m·n stored and
  re-read) then one ``2·b·m·n`` matmul;
* ``bsr``:   flops 2·b·s_tot; bytes s_tot + b·(m+n) + 2·b·Σ d_inner (every
  factor boundary round-trips its activation); J launches;
* ``fused``: flops 2·b·s_tot; bytes s_tot + b·(m+n); 1 launch.

Constants come from :func:`repro_torch.launch.roofline.roofline_constants`
(H100 data sheet).  Every decision is a :class:`DispatchReport`, the latest
one retrievable with :func:`last_report`.  Gradient-aware pricing, sharded
pricing and the measured autotune table come with later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch import roofline as _roofline

# ties go to the fewest-launch structured path
_ORDER = {"fused": 0, "bsr": 2, "dense": 3}

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class DispatchReport:
    """One backend decision, with its evidence."""

    requested: str
    backend: str
    batch: int
    shape: tuple[int, int]
    dtype: str
    device: str
    s_tot: int
    feasible: tuple[str, ...]
    est_us: dict  # backend -> modeled µs (feasible backends only)
    reason: str
    roofline: str = ""
    weight_bytes: int = 0

    def as_row(self) -> dict:
        return {
            "backend": self.backend,
            "requested": self.requested,
            "batch": self.batch,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "device": self.device,
            "s_tot": self.s_tot,
            "est_us": {k: round(v, 3) for k, v in self.est_us.items()},
            "reason": self.reason,
            "roofline": self.roofline,
            "weight_bytes": self.weight_bytes,
        }


_LAST_REPORT: DispatchReport | None = None


def last_report() -> DispatchReport | None:
    """The most recent decision (auto or forced) made in this process."""
    return _LAST_REPORT


def _record(report: DispatchReport) -> DispatchReport:
    global _LAST_REPORT
    _LAST_REPORT = report
    return report


def choose_backend(
    *,
    batch: int,
    shape: tuple[int, int],
    dtype: torch.dtype,
    s_tot: int,
    inner_dims: tuple[int, ...] = (),
    n_factors: int = 1,
    feasible: tuple[str, ...] = ("dense", "bsr", "fused"),
    requested: str = "auto",
    device: str = "",
) -> DispatchReport:
    """Pick the cheapest feasible backend under the roofline model (a pure
    function of its arguments; ``device`` is recorded, not consulted)."""
    consts, source = _roofline.roofline_constants()
    peak_flops, hbm_bw, launch_us = consts["peak_flops"], consts["hbm_bw"], consts["t_launch_us"]
    m, n = shape
    b = batch
    elt = torch.empty((), dtype=dtype).element_size()

    def roofline_us(flops: float, byts: float, launches: int) -> float:
        return max(flops / peak_flops, byts / hbm_bw) * 1e6 + launches * launch_us

    edge = b * (m + n)
    inner = 2 * b * sum(inner_dims)
    w_stream = elt * s_tot
    build_flops = 2.0 * s_tot * min(m, n)
    est = {
        "dense": roofline_us(2.0 * b * m * n + build_flops, elt * (2 * m * n + edge), n_factors),
        "bsr": roofline_us(2.0 * b * s_tot, w_stream + elt * (edge + inner), n_factors),
        "fused": roofline_us(2.0 * b * s_tot, w_stream + elt * edge, 1),
    }
    est = {k: v for k, v in est.items() if k in feasible}
    rank = lambda k: (est[k], _ORDER[k])  # noqa: E731
    backend = min(est, key=rank)
    runner_up = min((k for k in est if k != backend), key=rank, default=None)
    if runner_up is None:
        reason = f"only feasible backend ({backend}); weight_bytes={w_stream}"
    else:
        reason = (
            f"{backend} modeled {est[backend]:.2f}us vs {runner_up} {est[runner_up]:.2f}us "
            f"(batch={b}, s_tot={s_tot}, dense_nnz={m * n}, weight_bytes={w_stream})"
        )
    return DispatchReport(
        requested=requested,
        backend=backend,
        batch=b,
        shape=(m, n),
        dtype=_dtype_name(dtype),
        device=device,
        s_tot=s_tot,
        feasible=tuple(est),
        est_us=est,
        reason=reason,
        roofline=source,
        weight_bytes=w_stream,
    )


def dispatch(
    op,
    batch: int,
    dtype: torch.dtype,
    requested: str = "auto",
    *,
    device: str = "",
    record: bool = True,
) -> DispatchReport:
    """Decide (or, for a forced ``requested``, record) the backend of one
    leaf operator.  A forced report keeps the model's estimates and says
    what it would have picked.  ``record=False`` leaves
    :func:`last_report` untouched (an advisory query)."""
    report = choose_backend(
        batch=batch,
        shape=op.shape,
        dtype=dtype,
        s_tot=op.s_tot,
        inner_dims=op.inner_dims(),
        n_factors=op.n_factors,
        feasible=op.feasible_backends(),
        requested=requested,
        device=device,
    )
    if requested != "auto":
        report = dataclasses.replace(
            report,
            backend=requested,
            reason=f"forced by caller (cost model would pick {report.backend}: {report.reason})",
        )
    return _record(report) if record else report
