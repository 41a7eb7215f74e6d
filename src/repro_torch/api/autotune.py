"""Measured-timings table over the roofline dispatch model.
Counterpart of :mod:`repro.api.autotune`.

The roofline model assumes every kernel reaches its bound; on the card the
first fused kernel does not, and the model's pick can be the slowest
backend.  Where the table holds real timings for a dispatch key

    (shape, n_factors, s_tot, batch bucket, dtype, fwd, mesh, device[, vq])

an ``auto`` apply takes the measured-fastest feasible backend
(:func:`repro_torch.api.dispatch.dispatch`) and, for ``fused``, the batch
tile that won the sweep over ``kernels/chain.py`` ``SUPPORTED_BT``.  A ``grad`` key times
forward plus backward of a scalar loss wrt x and the operator's trained
tensors (values, or the scales of a quantized chain), so the fused path's
K2/K3 (K5) are in its time.

Modes (``REPRO_AUTOTUNE``, as the reference):

* ``off`` / ``0`` — the table is never read; dispatch is the model alone;
* unset (default) — read only: table hits steer ``auto``, nothing is
  measured;
* ``1`` / ``on`` / ``measure`` — an ``auto`` apply whose key is missing
  measures every feasible backend first and records the entry
  (``FaustOp.apply(autotune=True)`` does so whatever the mode).

The table is the port's own JSON file: ``build/autotune.json`` at the
repository root, or the path in ``REPRO_TORCH_AUTOTUNE_TABLE``.  The key's
device is the card's name, so timings never cross cards.  A missing,
corrupt or stale-version file reads as no table.  Measurement lets every
error propagate: a kernel that fails to launch is never hidden behind
another backend (the reference skips a failing tile).  The port has no
session quarantine: with no degraded ladder, no backend is ever demoted
from.

On a mesh every rank measures together (the sharded backend's collectives
need every rank): an operator carrying a ``ShardSpec`` is timed for a
fixed ``MESH_ROUNDS`` rounds, where the time budget would let ranks stop
at different rounds, and each candidate's time is the slowest rank's, so
every rank records the same entry and dispatches alike.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import torch

TABLE_VERSION = 1
DEFAULT_TABLE = Path(__file__).resolve().parents[3] / "build" / "autotune.json"
# timing: N_WARMUP calls of each candidate, then rounds of single calls
# alternating across the candidates; each candidate's median.  Rounds stop
# once ROUND_BUDGET_S seconds have passed (at least MIN_ROUNDS, at most
# MAX_ROUNDS), so a key costs about two seconds whatever its call time
N_WARMUP, MIN_ROUNDS, MAX_ROUNDS, ROUND_BUDGET_S = 2, 5, 400, 2.0
MESH_ROUNDS = 20  # rounds of an operator on a mesh: the same on every rank
# the fused sweep keeps FORWARD_BT unless another tile is faster by more
# than this share: at B = 128 under grad the tile changes only the forward
# kernel, and single sweeps picked a tile 7 % slower than the default there
TILE_MARGIN = 0.05
# Seconds between checks of the file's mtime: a table written by another
# process shows up within this time.  Every auto apply reads the table, and
# a stat per apply is a syscall on the serving path.
RECHECK_S = 1.0

# re-entrance guard: measurement drives FaustOp.apply with forced backends
_MEASURING = False
# in-memory copy of the table, keyed by (path, mtime_ns); when the file was
# last checked; and a generation that counts the copies read
_STATE: dict = {"stamp": None, "table": None, "checked": float("-inf"), "gen": 0}


def autotune_mode() -> str:
    """``"off"`` | ``"readonly"`` | ``"measure"`` from ``REPRO_AUTOTUNE``."""
    v = os.environ.get("REPRO_AUTOTUNE", "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("1", "on", "true", "yes", "measure"):
        return "measure"
    return "readonly"


def table_path() -> str:
    """Where the table lives: ``REPRO_TORCH_AUTOTUNE_TABLE`` or
    ``build/autotune.json`` at the repository root."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE_TABLE") or str(DEFAULT_TABLE)


def _stamp() -> tuple:
    path = table_path()
    try:
        return (path, os.stat(path).st_mtime_ns)
    except OSError:
        return (path, None)


def load_table() -> dict | None:
    """The validated table ``{"version", "entries"}``, or None when the
    file is absent, unreadable, corrupt or of another version.  The file's
    mtime is checked at most every ``RECHECK_S`` seconds; this process's
    own writes and :func:`reload` are seen at once."""
    now = time.monotonic()
    if (
        _STATE["stamp"] is not None
        and _STATE["stamp"][0] == table_path()
        and now - _STATE["checked"] < RECHECK_S
    ):
        return _STATE["table"]
    _STATE["checked"] = now
    stamp = _stamp()
    if _STATE["stamp"] == stamp:
        return _STATE["table"]
    table = None
    if stamp[1] is not None:
        try:
            with open(stamp[0], encoding="utf-8") as f:
                data = json.load(f)
            if (
                isinstance(data, dict)
                and data.get("version") == TABLE_VERSION
                and isinstance(data.get("entries"), dict)
            ):
                table = data
        except (OSError, ValueError):
            table = None
    _STATE["stamp"], _STATE["table"] = stamp, table
    _STATE["gen"] += 1
    return table


def table_generation() -> int:
    """A number that changes whenever the table in use does (after
    :func:`load_table`'s checks): dispatch reuses decisions while it holds."""
    load_table()
    return _STATE["gen"]


def reload() -> dict | None:
    """Drop the in-memory copy and read the file now."""
    _STATE["stamp"] = None
    return load_table()


def bucket_batch(b: int) -> int:
    """Next power of two ≥ b (min 1): the batch axis of the key."""
    return 1 << max(0, int(b) - 1).bit_length() if b > 1 else 1


def key_of(
    *,
    shape: tuple[int, int],
    n_factors: int,
    s_tot: int,
    batch: int,
    dtype: str,
    grad: bool,
    mesh_shape: tuple | None,
    device: str,
    vq: str | None = None,
) -> str:
    """The key a timing is filed under — the reference's spelling.  ``vq``
    (a quantized leaf's scheme, e.g. ``"int8:per_block"``) appends
    ``|vq:...`` so quantized and f32 operators never share timings."""
    mesh = "x".join(f"{a}{s}" for a, s in mesh_shape) if mesh_shape else "-"
    kind = "grad" if grad else "fwd"
    base = (
        f"{shape[0]}x{shape[1]}|J{n_factors}|s{s_tot}"
        f"|b{bucket_batch(batch)}|{dtype}|{kind}|mesh:{mesh}|{device}"
    )
    return f"{base}|vq:{vq}" if vq else base


@functools.lru_cache(maxsize=None)
def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def key_for_op(op, *, batch: int, dtype: torch.dtype, grad: bool = False, mesh_shape: tuple | None = None) -> str:
    """:func:`key_of` for an apply of ``op`` (``grad``: a training apply;
    ``mesh_shape``: its shard plan's mesh) — the one spelling dispatch and
    measurement share."""
    return key_of(
        shape=op.shape,
        n_factors=op.n_factors,
        s_tot=op.s_tot,
        batch=batch,
        dtype=str(dtype).removeprefix("torch."),
        grad=grad,
        mesh_shape=mesh_shape,
        device=_device_name(op.device),
        vq=getattr(op.rep, "qscheme", None),
    )


def lookup(key: str) -> dict | None:
    """The entry for ``key`` (``{"best", "us", "bt", ...}``), or None on a
    miss; ``off`` never hits."""
    if autotune_mode() == "off":
        return None
    table = load_table()
    if table is None:
        return None
    ent = table["entries"].get(key)
    if not isinstance(ent, dict) or not isinstance(ent.get("us"), dict):
        return None
    return ent


def record(key: str, entry: dict, path: str | None = None) -> None:
    """Merge one entry into the table file (read, modify, atomic rename)."""
    table = load_table() or {"version": TABLE_VERSION, "entries": {}}
    table["entries"][key] = entry
    _write_table(table, path or table_path())


def _write_table(table: dict, path: str) -> None:
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(table, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        Path(tmp).unlink(missing_ok=True)
        raise
    finally:
        _STATE["stamp"] = None  # the next load_table() reads the file


def op_key_prefix(op) -> str:
    """The key prefix every entry of one operator signature shares (shape,
    chain length, stored nonzeros), as the reference spells it."""
    return f"{op.shape[0]}x{op.shape[1]}|J{op.n_factors}|s{op.s_tot}|"


def invalidate(prefix: str, path: str | None = None) -> int:
    """Drop every entry whose key starts with ``prefix`` from the table
    (rewritten atomically, as :func:`record` does); returns how many went.
    A missing or unreadable table drops none."""
    table = load_table()
    if table is None:
        return 0
    victims = [k for k in table["entries"] if k.startswith(prefix)]
    if victims:
        for k in victims:
            del table["entries"][k]
        _write_table(table, path or table_path())
    return len(victims)


def _timeit_us(fns: dict, device: torch.device, rounds: int | None = None) -> dict:
    """µs a call of each ``fns[k]``: the median of single calls, one device
    synchronization after each, after ``N_WARMUP`` calls of each.  The
    calls alternate across the candidates round by round (the order
    rotated each round), so a stretch of host contention slows the calls
    of every candidate alike and the medians compare the candidates, not
    the moments they ran in; at training and serving batch a call is
    host-paced and the least of a few runs of back-to-back calls picked a
    tile 12 % slower than the default on a loaded host (PERF.md §6).

    The budget: rounds stop once ``ROUND_BUDGET_S`` (2 s) have passed since
    the first, after at least ``MIN_ROUNDS`` (5) and at most ``MAX_ROUNDS``
    (400): about 400 calls of each candidate at B = 128, where a call takes
    about a millisecond, and 5 to 40 at B = 4096 (3-13 ms a call).  Given
    ``rounds``, exactly that many rounds run."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for fn in fns.values():
        for _ in range(N_WARMUP):
            fn()
    sync()
    names = list(fns)
    samples: dict = {k: [] for k in names}
    start = time.perf_counter()
    for r in range(MAX_ROUNDS if rounds is None else rounds):
        if rounds is None and r >= MIN_ROUNDS and time.perf_counter() - start > ROUND_BUDGET_S:
            break
        for k in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            fns[k]()
            sync()
            samples[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) * 1e6 for k, v in samples.items()}


def _trainable(op):
    """A leaf like ``op`` whose trained tensors are fresh leaves that
    require grad, sharing ``op``'s storage: the values of a Faust,
    BlockFaust or f32 PackedChain, the scales of a quantized one."""
    from repro_torch.api.operator import FaustOp
    from repro_torch.core.compress import BlockFaust, PackedChain

    leaf = lambda t: t.detach().requires_grad_(True)  # noqa: E731
    rep = op.rep
    if isinstance(rep, PackedChain):
        name = "scales" if rep.quantized else "values"
        rep = dataclasses.replace(rep, **{name: leaf(getattr(rep, name))})
    elif isinstance(rep, BlockFaust):
        rep = BlockFaust(tuple(dataclasses.replace(f, values=leaf(f.values)) for f in rep.factors), rep.lam)
    else:
        rep = type(rep)(tuple(leaf(s) for s in rep.factors), rep.lam)
    return FaustOp(rep, op.adjoint, op.conj, shard=getattr(op, "shard", None))


def measure(op, x: torch.Tensor, *, grad: bool = False, use_kernel: bool) -> dict:
    """Time every feasible backend of the leaf ``op`` on ``x`` and return
    the table entry, not yet recorded.  ``grad=True`` times forward plus
    backward of ``sum(op.apply(x))`` wrt x and the operator's trained
    tensors.  With the kernels on, the fused backend sweeps every supported
    forward tile; the winner is the entry's ``bt``, the default tile where
    none beats it by ``TILE_MARGIN``.  Every candidate is timed in the
    same alternating rounds (:func:`_timeit_us`).  Errors propagate."""
    from repro_torch.kernels.chain import FORWARD_BT, SUPPORTED_BT

    global _MEASURING
    us: dict[str, float] = {}
    entry: dict = {}
    x = x.detach()
    if grad:
        top = _trainable(op)
        params = [t for t in top._tensors() if t.requires_grad]
        xg = x.requires_grad_(True) if x.is_floating_point() else x

        def run(backend, bt):
            with torch.enable_grad():
                y = top.apply(xg, backend, use_kernel=use_kernel, bt=bt, device=x.device,
                              autotune=False, grad=True)
                torch.autograd.grad(y.sum(), [xg, *params])
    else:
        def run(backend, bt):
            with torch.no_grad():
                op.apply(x, backend, use_kernel=use_kernel, bt=bt, device=x.device, autotune=False)
    shard = getattr(op, "shard", None)
    cands = [(backend, bt) for backend in op.feasible_backends()
             for bt in (SUPPORTED_BT if backend in ("fused", "fused_sharded") and use_kernel else (FORWARD_BT,))]
    _MEASURING = True
    try:
        fns = {c: (lambda c=c: run(*c)) for c in cands}
        times = _timeit_us(fns, x.device) if shard is None else _timeit_us(fns, x.device, MESH_ROUNDS)
    finally:
        _MEASURING = False
    if shard is not None:  # the slowest rank's time, the same on every rank
        from repro_torch.distributed.mesh import all_reduce

        slowest = all_reduce(torch.tensor([times[c] for c in cands], dtype=torch.float64, device=shard.mesh.device),
                             shard.mesh.group(shard.mesh.axis_names), torch.distributed.ReduceOp.MAX)
        times = dict(zip(cands, slowest.tolist()))
    for backend in op.feasible_backends():
        per_tile = {bt: t for (b, bt), t in times.items() if b == backend}
        win = min(per_tile, key=per_tile.get)
        if per_tile[win] * (1.0 + TILE_MARGIN) > per_tile[FORWARD_BT]:
            win = FORWARD_BT  # a tile within the margin of the default is noise
        us[backend] = per_tile[win]
        if len(per_tile) > 1:
            entry["bt"] = win
            entry["bt_us"] = {str(t): round(v, 3) for t, v in per_tile.items()}
    return {
        "best": min(us, key=us.get),
        "us": {k: round(v, 3) for k, v in us.items()},
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "ctx": {"use_kernel": bool(use_kernel), "device": _device_name(x.device), "grad": bool(grad)},
        **entry,
    }


def ensure_measured(op, x: torch.Tensor, *, batch: int, dtype: torch.dtype, grad: bool = False,
                    use_kernel: bool, mesh_shape: tuple | None = None) -> dict | None:
    """Measure and record the key of this apply (``grad``: a training
    apply) if the table lacks it.  Returns the entry, or None re-entrantly
    from a measurement apply or for a composite (its leaves measure)."""
    if _MEASURING or op.kind != "leaf":
        return None
    key = key_for_op(op, batch=batch, dtype=dtype, grad=grad, mesh_shape=mesh_shape)
    table = load_table()
    if table is not None and isinstance(table["entries"].get(key), dict):
        return table["entries"][key]
    entry = measure(op, x, grad=grad, use_kernel=use_kernel)
    record(key, entry)
    return entry
