"""Cost-model backend dispatch for :class:`repro_torch.api.operator.FaustOp`.
Counterpart of :mod:`repro.api.dispatch` (forward and joint training
pricing).

    t(backend) ≈ max(flops / PEAK_FLOPS, bytes / HBM_BW) + launches·t_launch

* ``dense``: build the matrix (≈ 2·s_tot·min(m,n) flops, m·n stored and
  re-read) then one ``2·b·m·n`` matmul;
* ``bsr``:   flops 2·b·s_tot; bytes w + b·(m+n) + 2·b·Σ d_inner (every
  factor boundary round-trips its activation); J launches;
* ``fused``: flops 2·b·s_tot; bytes w + b·(m+n); 1 launch;
* ``fused_sharded`` (an operator carrying a ``ShardSpec``): the fused
  chain per rank (:mod:`repro_torch.kernels.chain_sharded`), its flops
  and bytes divided by the shard counts, one launch per segment, plus a
  link term ``bytes / link_bw`` for the boundary all-gathers (the
  reference's ``ici_bytes``) and for the port's gather of the whole
  result on every rank (caveat R7);

where ``w`` is the weight stream: ``elt·s_tot``, or for a quantized chain
the stored itemsize times s_tot plus the scale bytes.

``grad=True`` (a training apply; ``FaustOp.apply`` detects autograd)
prices forward and backward together with the reference's formulas: three
passes per backend, the structured paths streaming the weights three
times and writing the weight cotangent once; ``bsr`` pays the boundary
activations in every pass and 3·J launches; ``fused`` runs the chain
backward kernels (dgrad, and wgrad's recompute and walk: five flop passes
in all).  The one term that prices the port's own kernel is the wgrad
workspace (:func:`_wgrad_workspace_bytes`), where the reference priced
its per-batch-tile partial slabs; and the wgrad kernel is two launches
where the chain has intermediates (walk and emission), so ``fused``
counts four launches for J > 1, three for J = 1.  ``bsr`` over
block-sparse factors is priced as the port runs it: its backward is the
plain gather and scatter einsums (``kernels/ref.py``), which write and
read two f32 intermediates of ``b·s_j/bn`` elements per factor
(:func:`_bsr_bwd_bytes`) and launch ``BSR_BWD_LAUNCHES`` kernels per
factor beside the forward's one, where the reference priced 3·J launches
and no intermediates.  Without that, f32 priced at the FFMA peak made the
model pick ``bsr`` under grad at B = 128, where ``fused`` runs twice as
fast on the H100 (PERF.md §5).

Constants come from :func:`repro_torch.launch.roofline.roofline_constants`
(H100 data sheet).  Operations are priced at the peak of the activation
dtype: ``peak_flops_f32`` (FFMA) for f32, ``peak_flops`` (bf16 tensor
cores) otherwise; a constants dict without the f32 key prices f32 at
``peak_flops``, as the reference does.  Above the model sits the measured
table (:mod:`repro_torch.api.autotune`): unless ``REPRO_AUTOTUNE=off``, an
``auto`` request whose key (forward or ``grad``) the table holds takes the
measured-fastest feasible backend, ``source`` is ``"measured"`` and
``est_us`` holds the measured µs.  Every decision is a :class:`DispatchReport`,
the latest one retrievable with :func:`last_report`.  ``link_bw`` is the
data sheet's NVLink rate (450e9 B/s each way): the port's calibration has
one card and no link to measure.
"""
from __future__ import annotations

import dataclasses
import types
import weakref

import torch

from repro_torch.kernels.chain import FORWARD_BT
from repro_torch.launch import roofline as _roofline

# ties go to the fewest-launch structured path (one card before the mesh:
# a tie means the mesh buys nothing)
_ORDER = {"fused": 0, "fused_sharded": 1, "bsr": 2, "dense": 3}
# Decisions already made, reused while nothing they depend on changed:
# (id(op), batch, dtype, requested, device, bt, table generation, roofline)
# -> (weakref to op, report).  A decision costs ~50 µs of host time on the
# H100's host (PERF.md §5), a large share of a serving-batch apply.
_MEMO: dict = {}
_MEMO_MAX = 1024

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# kernels the bsr backward launches per block-sparse factor
# (kernels/ref.py bsr_matmul_dx and bsr_matmul_dvalues in f32): two bmm,
# the zero fill and the scatter-add of dx, the gather of x's blocks, the
# two index casts and the copy that lays the per-block dx out for the add
BSR_BWD_LAUNCHES = 8


# flop passes over a chain's stored entries of each fused kernel: the
# forward (K1/K4) and dgrad (K2/K5) one each, the wgrad (K3/K5) three (its
# recompute, walk and emission)
CHAIN_PASSES = {"forward": 1, "dgrad": 1, "wgrad": 3}


def chain_flops(batch: int, s_tot: int, kernel: str = "forward") -> float:
    """The flops the model prices one ``kernel`` launch at, 2·b·s_tot a
    pass; also the kernels' flop formula (``kernels/library.py``), K6's
    being one forward pass over its factor's entries."""
    return CHAIN_PASSES[kernel] * 2.0 * batch * s_tot


def _bsr_bwd_bytes(b: int, gather: int) -> float:
    """Device-memory bytes of the bsr backward's f32 intermediates: the
    gathered x blocks and the per-block dx contributions, ``b·gather``
    floats each (``gather = Σ_j s_j / bn_j``), each written and read once."""
    return 16.0 * b * gather


def _wgrad_workspace_bytes(b: int, inner_dims: tuple[int, ...]) -> float:
    """Device-memory bytes of the wgrad kernel's f32 workspaces
    (``kernels/chain_bwd.py``): the walk writes every intermediate
    activation and cotangent, ``2·b·Σ d_inner`` floats, and the emission
    reads them back.  Where the reference priced one ``s_tot`` f32 partial
    slab per extra batch tile, the port's kernel has none."""
    return 16.0 * b * sum(inner_dims)


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
    est_us: dict  # backend -> µs (modeled, or measured when source == "measured"); read only
    reason: str
    roofline: str = ""
    # "model" (roofline) or "measured" (a hit in the autotune table)
    source: str = "model"
    # the fused forward kernel's (K1/K4) batch tile: caller > table winner >
    # FORWARD_BT; the backward kernels run at their own (kernels/ops.py)
    bt: int = FORWARD_BT
    weight_bytes: int = 0  # weight stream priced: values (stored itemsize) + scales
    values_dtype: str = ""  # stored values' dtype (int8/float8_* when quantized)
    grad: bool = False  # est_us are joint forward+backward costs
    # mesh facts (None / 0 when the operator carries no ShardSpec)
    mesh_shape: tuple | None = None  # ((axis, size), ...) of the mesh
    collective_bytes: int = 0  # a rank's boundary all-gather bytes (the reference's count)
    gather_bytes: int = 0  # a rank's bytes of the whole result's gather (caveat R7)

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
            "source": self.source,
            "bt": self.bt,
            "weight_bytes": self.weight_bytes,
            "values_dtype": self.values_dtype,
            "grad": self.grad,
            "mesh_shape": self.mesh_shape,
            "collective_bytes": self.collective_bytes,
            "gather_bytes": self.gather_bytes,
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
    bt: int = FORWARD_BT,
    values_dtype: str | None = None,
    scales_bytes: int = 0,
    grad: bool = False,
    bsr_gather: int = 0,
    shard: dict | None = None,
) -> DispatchReport:
    """Pick the cheapest feasible backend under the roofline model (a pure
    function of its arguments; ``device`` and ``bt`` are recorded, not
    consulted).  ``values_dtype``/``scales_bytes`` describe a quantized
    chain: its weight stream is priced at the stored itemsize plus the
    scale bytes; unquantized pricing is unchanged.  ``grad=True`` prices
    forward and backward together (module docstring); ``bsr_gather`` is
    ``Σ_j s_j / bn_j`` of block-sparse factors, whose bsr backward is the
    gather/scatter form, and 0 for dense factors (the reference's pricing).
    ``shard`` is the operator's ``ShardPlan.summary()``: with it
    ``fused_sharded`` joins the priced backends (:func:`_sharded_est`)."""
    consts, source = _roofline.roofline_constants()
    peak_flops, hbm_bw, launch_us = consts["peak_flops"], consts["hbm_bw"], consts["t_launch_us"]
    if dtype == torch.float32:
        peak_flops = consts.get("peak_flops_f32", peak_flops)
    m, n = shape
    b = batch
    elt = dtype.itemsize

    def roofline_us(flops: float, byts: float, launches: int, link_bytes: float = 0.0) -> float:
        return (max(flops / peak_flops, byts / hbm_bw) + link_bytes / consts["link_bw"]) * 1e6 + launches * launch_us

    edge = b * (m + n)
    inner = 2 * b * sum(inner_dims)
    quant = values_dtype is not None
    w_elt = getattr(torch, values_dtype).itemsize if quant else elt
    w_stream = w_elt * s_tot + scales_bytes
    build_flops = 2.0 * s_tot * min(m, n)
    if not grad:
        est = {
            "dense": roofline_us(2.0 * b * m * n + build_flops, elt * (2 * m * n + edge), n_factors),
            "bsr": roofline_us(chain_flops(b, s_tot), w_stream + elt * (edge + inner), n_factors),
            "fused": roofline_us(chain_flops(b, s_tot), w_stream + elt * edge, 1),
        }
    else:
        # the weight cotangent: f32 for codes (wrt the dequantized values)
        dv_bytes = 4.0 * s_tot if quant else elt * s_tot
        est = {
            "dense": roofline_us(
                3 * 2.0 * b * m * n + 3.0 * build_flops, elt * (4 * m * n + 3 * edge), 3 * n_factors
            ),
            "bsr": roofline_us(
                3 * 2.0 * b * s_tot,
                3 * w_stream + dv_bytes + elt * (3 * edge + 3 * inner) + _bsr_bwd_bytes(b, bsr_gather),
                (1 + BSR_BWD_LAUNCHES) * n_factors if bsr_gather else 3 * n_factors,
            ),
            "fused": roofline_us(
                sum(chain_flops(b, s_tot, k) for k in CHAIN_PASSES),
                3 * w_stream + dv_bytes + elt * 3 * edge + _wgrad_workspace_bytes(b, inner_dims),
                4 if inner_dims else 3,
            ),
        }
    coll_bytes = gather_bytes = 0
    if shard is not None and "fused_sharded" in feasible:
        est["fused_sharded"], coll_bytes, gather_bytes = _sharded_est(
            roofline_us, b, m, n, s_tot, elt, shard, inner_dims, grad, w_elt, scales_bytes, quant)
    est = {k: v for k, v in est.items() if k in feasible}
    rank = lambda k: (est[k], _ORDER[k])  # noqa: E731
    backend = min(est, key=rank)
    runner_up = min((k for k in est if k != backend), key=rank, default=None)
    if runner_up is None:
        reason = f"only feasible backend ({backend}); weight_bytes={w_stream}"
    else:
        reason = (
            f"{backend} modeled {est[backend]:.2f}us{' fwd+bwd' if grad else ''} vs "
            f"{runner_up} {est[runner_up]:.2f}us "
            f"(batch={b}, s_tot={s_tot}, dense_nnz={m * n}, weight_bytes={w_stream})"
        )
    if shard is not None and "fused_sharded" in est:
        reason += (f"; sharded plan: {shard['mode']}, {shard['n_segments']} segment(s), "
                   f"{coll_bytes} link bytes/shard (+{gather_bytes} to gather the result)")
    return DispatchReport(
        requested=requested,
        backend=backend,
        batch=b,
        shape=(m, n),
        dtype=_dtype_name(dtype),
        device=device,
        s_tot=s_tot,
        feasible=tuple(est),
        est_us=types.MappingProxyType(est),  # reports are shared: see dispatch()
        reason=reason,
        roofline=source,
        bt=bt,
        weight_bytes=int(w_stream),
        values_dtype=values_dtype if quant else _dtype_name(dtype),
        grad=grad,
        mesh_shape=shard.get("mesh_shape") if shard is not None else None,
        collective_bytes=coll_bytes,
        gather_bytes=gather_bytes,
    )


def _sharded_est(roofline_us, b: int, m: int, n: int, s_tot: int, elt: int, shard: dict,
                 inner_dims: tuple[int, ...], grad: bool, w_elt: int, scales_bytes: int,
                 quant: bool) -> tuple[float, int, int]:
    """(µs, boundary bytes, result-gather bytes) of the sharded fused
    apply: the reference's per-rank roofline plus link terms.

    ``model`` mode: each of the ``n_model`` ranks streams ``s_tot/n_model``
    weights and ``b_loc·(m + n/n_model)`` edge activations, receives the
    boundary all-gathers' bytes (:func:`~repro_torch.kernels.chain_sharded.ici_bytes`)
    and writes and reads each gathered activation, one launch per segment.
    ``replicated`` mode: all the weights on every rank, the batch split
    over every fitting axis, no boundary; a chain that does not pack runs
    per factor and is priced like ``bsr``.  Both then gather the whole
    result on every rank (caveat R7), a link term the reference has no
    counterpart of.  ``grad=True``: the three-pass joint cost of the
    single-card ``fused`` pricing per rank (``bsr``'s for the per-factor
    chain), the boundary term tripled (its reduce-scatter runs in K2's
    and K3's passes), the result gather once (its backward is a slice),
    plus the gradient collectives: x's sum over the model ranks and row
    gather, the values' sum over the data ranks and shard gather."""
    from repro_torch.kernels.chain_sharded import ici_bytes, output_gather_bytes

    n_model = max(int(shard.get("n_model", 1)), 1)
    n_data = max(int(shard.get("n_data", 1)), 1)
    launches = int(shard.get("n_segments", 1))
    model = shard.get("mode") == "model"
    n_batch = n_data if model else n_data * n_model
    b_loc = -(-b // n_batch)
    if model:
        s_loc = s_tot / n_model
        cross = tuple(shard.get("crossing_feats", ()))
        coll_bytes = ici_bytes(b, elt, n_data, n_model, cross)
        boundary_hbm = elt * b_loc * sum(w * (1 + 1 / n_model) for w in cross)
        w_loc = w_elt * s_loc + scales_bytes / n_model
        byts = w_loc + elt * b_loc * (m + n / n_model) + boundary_hbm
    else:
        s_loc = float(s_tot)
        coll_bytes = 0
        w_loc = w_elt * s_loc + scales_bytes
        byts = w_loc + elt * b_loc * (m + n)
        if not shard.get("fusable", True):
            byts += elt * 2 * b_loc * sum(inner_dims)
    flops = 2.0 * b_loc * s_loc
    gather = output_gather_bytes(b, n, elt, n_data, n_model, n_batch)
    link = coll_bytes + gather
    if grad:
        dv_loc = 4.0 * s_loc if quant else elt * s_loc
        if not model and not shard.get("fusable", True):
            flops, byts = 3.0 * flops, 3.0 * byts + dv_loc
        else:
            flops = 5.0 * flops
            byts = 3.0 * w_loc + dv_loc + 4.0 * (byts - w_loc) + _wgrad_workspace_bytes(b_loc, inner_dims)
        launches *= 3
        # x's gradient: summed over the model ranks (a ring all-reduce of
        # the rank's rows), then the rows gathered; the values' gradient:
        # summed over the ranks that read the same rows, then the model
        # ranks' shards gathered
        dx = elt * b * m * (n_batch - 1) / n_batch
        if model:
            dx += elt * b_loc * m * 2 * (n_model - 1) / n_model
        dv_ranks = n_data if model else n_batch
        dv = dv_loc * 2 * (dv_ranks - 1) / dv_ranks + (dv_loc * (n_model - 1) if model else 0.0)
        link = 3 * coll_bytes + gather + dx + dv
    return roofline_us(flops, byts, launches, link), coll_bytes, int(gather)


def dispatch(
    op,
    batch: int,
    dtype: torch.dtype,
    requested: str = "auto",
    *,
    device: str = "",
    bt: int | None = None,
    record: bool = True,
    grad: bool = False,
    shard: dict | None = None,
) -> DispatchReport:
    """Decide (or, for a forced ``requested``, record) the backend of one
    leaf operator (``grad``: of a training apply).  A forced report keeps
    the model's estimates and says what it would have picked.  An ``auto``
    request consults the measured table first (unless
    ``REPRO_AUTOTUNE=off``); on a hit the backend is the measured-fastest
    feasible one and measured µs are never mixed with modeled ones.  ``bt`` is the caller's batch tile for the fused forward
    kernel (K1/K4); ``None`` takes the table's winner, else ``FORWARD_BT``.
    ``record=False`` leaves :func:`last_report` untouched (an advisory
    query).  A decision is made once per operator and arguments, and made
    again when the table or the roofline constants change; the report is
    shared, so treat it as read only.  ``shard`` is the operator's
    ``ShardPlan.summary()`` when it carries a ``ShardSpec``."""
    from repro_torch.api import autotune as _autotune

    consult = requested == "auto" and _autotune.autotune_mode() != "off"
    consts, source = _roofline.roofline_constants()
    key = (id(op), batch, dtype, requested, device, bt, grad,
           _autotune.table_generation() if consult else None, source, tuple(consts.items()),
           tuple(shard.items()) if shard is not None else None)
    hit = _MEMO.get(key)
    if hit is not None and hit[0]() is op:
        report = hit[1]
    else:
        report = _decide(op, batch, dtype, requested, device, bt, consult, grad, shard)
        if len(_MEMO) >= _MEMO_MAX:
            _MEMO.clear()
        _MEMO[key] = (weakref.ref(op), report)
    return _record(report) if record else report


def _decide(op, batch, dtype, requested, device, bt, consult, grad, shard) -> DispatchReport:
    from repro_torch.api import autotune as _autotune

    entry = None
    if consult:
        mesh_shape = shard["mesh_shape"] if shard is not None else None
        entry = _autotune.lookup(_autotune.key_for_op(op, batch=batch, dtype=dtype, grad=grad,
                                                      mesh_shape=mesh_shape))
    if bt is None:
        bt = int(entry["bt"]) if entry is not None and entry.get("bt") else FORWARD_BT
    values_dtype, scales_bytes = op.quant_info()
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
        bt=bt,
        values_dtype=values_dtype,
        scales_bytes=scales_bytes,
        grad=grad,
        bsr_gather=op.bsr_gather(),
        shard=shard,
    )
    if entry is not None:
        measured = {
            k: float(v) for k, v in entry["us"].items()
            if k in report.feasible and isinstance(v, (int, float))
        }
        if measured:
            rank = lambda k: (measured[k], _ORDER[k])  # noqa: E731
            backend = min(measured, key=rank)
            runner = min((k for k in measured if k != backend), key=rank, default=None)
            vs = f" vs {runner} {measured[runner]:.2f}us" if runner else ""
            report = dataclasses.replace(
                report,
                backend=backend,
                est_us=types.MappingProxyType(measured),
                feasible=tuple(measured),
                source="measured",
                reason=(
                    f"measured table hit: {backend} {measured[backend]:.2f}us{vs} "
                    f"(model would pick {report.backend}; weight_bytes={report.weight_bytes})"
                ),
            )
    if requested != "auto":
        report = dataclasses.replace(
            report,
            backend=requested,
            reason=f"forced by caller (cost model would pick {report.backend}: {report.reason})",
        )
    return report
