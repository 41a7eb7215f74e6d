"""Online PALM4MSA — track a drifting target with warm-started sweeps.
Counterpart of :mod:`repro.streaming.online`.

A cold :func:`repro_torch.api.factorize.factorize` pays the full
hierarchical schedule — ``n_splits · (n_iter_two + n_iter_global)`` PALM
sweeps — every time the target moves.  :class:`StreamingFaust` keeps the
*last factor state* and, per target snapshot ``A_t``, runs a short
warm-started global refinement: the previous factors came out of
projections, so they are a feasible start (``init_feasible=True`` with
the best iterate kept) and each update is no worse than its start.

Three-way budget controller, decided per step from a sketched relative
error ``‖A_t X − op X‖/‖A_t X‖`` over Gaussian probe columns (O(s_tot ·
probes), never the dense operator):

* drift ≤ ``skip_below``    → **skip** (0 sweeps);
* drift ≥ ``full_above``    → **full** hierarchical refactorization (the
  support has rotted; warm sweeps cannot move it across the constraint
  sets' combinatorial gaps);
* otherwise                 → **incremental** warm sweep
  (``n_iter_update`` sweeps on the converged flat schedule).

Warm sweeps run through :func:`repro_torch.core.hierarchical._run_palm`,
so ``StreamingFaust.trace_stats`` counts their solve buckets as the
reference counts its trace-cache hits (one miss, then hits).  Sweep
accounting (``sweeps_total``, per-record ``sweeps``) is the cost unit.
The probes come from a ``torch.Generator`` seeded by ``(cfg.seed, step,
salt)``, drawn on the CPU and moved to the target's device, so a run is
deterministic on any device.

On a mesh (``spec.mesh``; every rank tracks the same targets) the refresh
is placed as ``factorize`` places (``_shard_of``): rank 0's factors are
broadcast, so every rank's tracker state and published operator are rank
0's, and the controller reads rank 0's drift, so every rank takes the
same action.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.factorize import FactorizeSpec, TargetPrep, _finish, _shard_of, factorize
from repro_torch.core.compress import BlockFaust, _faust_to_blockfaust
from repro_torch.core.faust import Faust
from repro_torch.core.hierarchical import CacheStats, HierarchicalSpec, _run_palm
from repro_torch.device import resolve_device

SKIP, SWEEP, FULL = "skip", "sweep", "full"


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Budget-controller policy + sketch parameters (the reference's
    defaults)."""

    n_probes: int = 8  # sketch width of the drift estimate
    skip_below: float = 0.0  # drift ≤ this → skip (0: never skip)
    full_above: float = 0.5  # drift ≥ this → full refactorization
    n_iter_update: int = 8  # warm sweeps per incremental update
    seed: int = 0  # probe generator seed (deterministic per step)


@dataclasses.dataclass(frozen=True)
class UpdateRecord:
    """What one :meth:`StreamingFaust.update` did and what it cost."""

    step: int
    action: str  # "skip" | "sweep" | "full"
    drift: float  # pre-update sketched RE vs the published op
    re_est: float  # post-update sketched RE
    sweeps: int  # PALM sweeps this update paid


def probes(n: int, k: int, seed: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(n, k)`` standard Gaussian probes from ``torch.Generator`` seed
    ``seed``, drawn on the CPU (the same numbers on every device)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, k), generator=g, dtype=torch.float32).to(device=device, dtype=dtype)


class StreamingFaust:
    """A FAµST operator that tracks a drifting dense target.

    Build with :meth:`track` (cold-factorizes the first snapshot), then
    feed snapshots to :meth:`update`.  The refreshed operator is
    ``self.op``, in the frame ``factorize`` returns (the block route stays
    a deployment ``BlockFaust``), so it hot-swaps into the serving runtime
    through :func:`repro_torch.streaming.swap.hot_swap`.
    """

    def __init__(self, spec: FactorizeSpec, cfg: StreamingConfig, faust: Faust, op, hier: HierarchicalSpec,
                 prep: TargetPrep, cold_sweeps: int):
        self.spec, self.cfg = spec, cfg
        self.faust, self.op = faust, op
        self.hier, self.prep = hier, prep
        self.cold_sweeps = cold_sweeps  # one full refactorization's cost
        self.sweeps_total = cold_sweeps
        self.trace_stats = CacheStats()  # warm-sweep solve buckets
        self.history: list[UpdateRecord] = []
        self._step = 0
        self._block_route = spec.strategy == "hierarchical" and spec.hier is None and spec.block is not None

    # -- construction -------------------------------------------------------
    @classmethod
    def track(cls, a0, spec: FactorizeSpec, cfg: StreamingConfig = StreamingConfig(), *,
              device=None) -> "StreamingFaust":
        """Cold-factorize the first snapshot (on ``device``, default the
        CUDA card) and start tracking it."""
        a0 = torch.as_tensor(a0)
        if a0.ndim != 2:
            raise ValueError(f"StreamingFaust tracks one (m, n) target; got {tuple(a0.shape)}")
        if spec.strategy in ("palm4msa", "dictionary"):
            raise ValueError(
                "StreamingFaust needs a hierarchical-family strategy (the "
                "full refactorization fallback and the converged flat "
                f"constraint schedule come from it); got {spec.strategy!r}"
            )
        op, info = factorize(a0, spec, device=resolve_device(device))
        return cls(spec, cfg, info.fausts[0], op, info.hier_spec, info.prep, info.n_sweeps)

    @property
    def device(self) -> torch.device:
        return self.op.device

    def _target(self, a_t) -> torch.Tensor:
        return torch.as_tensor(a_t).to(self.device)

    # -- the flat constraint schedule of the converged state ----------------
    @property
    def refine_projs(self) -> tuple:
        """Per-factor projections of the final global refinement — the
        constraint sets the converged chain ``[S_1..S_{J-1}, T]`` lives in,
        and so the schedule warm sweeps refine under."""
        return tuple(self.hier.factor_projs) + (self.hier.resid_projs[-1],)

    # -- drift monitor ------------------------------------------------------
    def estimate_drift(self, a_t, salt: int = 0) -> float:
        """Sketched RE ``‖A_t X − op X‖_F / ‖A_t X‖_F`` over
        ``cfg.n_probes`` Gaussian probe columns — O(s_tot · probes), no
        dense materialization.  Deterministic in ``(cfg.seed, step,
        salt)``."""
        a_t = self._target(a_t)
        seed = self.cfg.seed * 1_000_003 + 2 * self._step + salt
        x = probes(a_t.shape[1], self.cfg.n_probes, seed, a_t.dtype, a_t.device)
        with torch.no_grad():
            y_true = a_t @ x
            y_op = self.op @ x
            denom = torch.clamp(torch.linalg.norm(y_true), min=1e-12)
            return float(torch.linalg.norm(y_true - y_op) / denom)

    # -- the online update --------------------------------------------------
    def update(self, a_t) -> UpdateRecord:
        """Track one target snapshot: probe drift, let the budget
        controller pick skip / incremental warm sweep / full hierarchical
        refactorization, refresh ``self.op``, and account the sweeps."""
        a_t = self._target(a_t)
        drift = self._agreed(self.estimate_drift(a_t, salt=0))
        if drift <= self.cfg.skip_below:
            action, sweeps = SKIP, 0
        elif drift >= self.cfg.full_above:
            action, sweeps = FULL, self._refactorize(a_t)
        else:
            action, sweeps = SWEEP, self._warm_sweep(a_t)
        self.sweeps_total += sweeps
        re_est = self._agreed(self.estimate_drift(a_t, salt=1))
        rec = UpdateRecord(self._step, action, drift, re_est, sweeps)
        self.history.append(rec)
        self._step += 1
        return rec

    def _agreed(self, value: float) -> float:
        """Rank 0's ``value`` on every rank of the spec's mesh (``value``
        itself off a mesh)."""
        from repro_torch.distributed.mesh import Mesh, broadcast

        mesh = self.spec.mesh
        if not isinstance(mesh, Mesh):
            return value
        return float(broadcast(torch.tensor([value], dtype=torch.float64, device=mesh.device), 0))

    def _warm_sweep(self, a_t: torch.Tensor) -> int:
        """Incremental update: ``n_iter_update`` warm PALM sweeps on the
        converged flat schedule, started from the current factors (one
        matrix as a stack of 1, as every solve of the port)."""
        a_p = self.prep.apply(a_t)
        res = _run_palm(
            self.trace_stats,
            a_p[None],
            tuple(f[None] for f in self.faust.factors),
            torch.as_tensor(self.faust.lam, dtype=a_p.dtype, device=a_p.device).reshape(1),
            self.refine_projs,
            self.cfg.n_iter_update,
            alpha=self.hier.alpha,
            power_iters=self.hier.power_iters,
            init_feasible=True,  # the previous factors came out of projections
        )
        self._publish(Faust(tuple(f[0] for f in res.factors), res.lam[0]))
        return self.cfg.n_iter_update

    def _refactorize(self, a_t: torch.Tensor) -> int:
        """Full cold restart — the controller's answer to support rot."""
        op, info = factorize(a_t, self.spec, device=a_t.device)
        self.faust, self.op = info.fausts[0], op
        self.hier, self.prep = info.hier_spec, info.prep
        return info.n_sweeps

    def _publish(self, faust: Faust) -> None:
        """Rebuild ``self.op`` from refreshed factors in the frame
        ``factorize`` used (the block re-pack and the mesh placement
        included)."""
        bfs = None
        if self._block_route:
            bk = self.spec.block
            in_f, out_f = self.op.shape
            bfs = [_faust_to_blockfaust(faust, self.prep.transpose, bk, bk, in_f, out_f)]
        self.op, info = _finish(self.spec.strategy, False, [faust], blockfausts=bfs, shard=_shard_of(self.spec))
        self.faust = info.fausts[0]

    # -- convenience --------------------------------------------------------
    @property
    def blockfaust(self) -> BlockFaust | None:
        """Deployment chain of the published op (block route only)."""
        rep = self.op.rep
        return rep if isinstance(rep, BlockFaust) else None

    def sweeps_saved(self) -> int:
        """Sweeps a cold-refactorize-every-step policy would have paid
        minus what tracking actually paid (the streaming win)."""
        return self.cold_sweeps * (len(self.history) + 1) - self.sweeps_total
