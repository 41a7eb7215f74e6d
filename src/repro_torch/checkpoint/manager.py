"""Asynchronous, verified, sharded checkpoints.  Counterpart of
:mod:`repro.checkpoint.manager`, with the same on-disk format.

* **Layout**: one directory per step.  Each leaf of the saved tree is
  stored as one or more ``.npy`` shard files named by the shard's offset
  in the whole leaf, ``<name>@<offset>.npy`` (``/`` in the name becomes
  ``__``), and ``manifest.json`` records every leaf's global shape, dtype
  and shards (offset, shard shape, sha256) with the caller's ``extra``.
* **On a mesh** (``CheckpointManager(mesh=)``, and ``shardings=``: the
  tree's :class:`~repro_torch.distributed.sharding.Block` of each leaf on
  this rank) every rank writes only its blocks, and a block held by
  several ranks (a leaf replicated over some axes) is written once, by
  the one at coordinate 0 on those axes.  The ranks' shard records are
  gathered on the calling thread; after every rank's writes (a
  collective in :meth:`~CheckpointManager.wait`) rank 0 writes the
  manifest and renames the step into place, then all ranks pass a
  barrier.  Every rank must call ``save_async``, ``wait`` and the
  restores together.
* **Dtypes**: bf16 is stored as its ``uint16`` bits with ``"bfloat16"``
  as the manifest's dtype (numpy has no bfloat16).
* **Atomicity**: a step is written to ``<step>.tmp`` and renamed after
  its manifest lands, so a crash mid-write never leaves a half step.
* **Async**: :meth:`CheckpointManager.save_async` copies every leaf to
  host memory and hashes it (synchronously: the hash is of the exact
  bytes handed to the writer; ``IO_THREADS`` leaves at a time), then
  writes on a background thread.  A
  failed background write is re-raised from :meth:`~CheckpointManager.wait`
  and from the next save, never lost in the thread (on a mesh, on every
  rank).
* **Integrity**: :meth:`~CheckpointManager.restore` re-hashes every shard
  it reads and raises :class:`CorruptCheckpointError` on a mismatch or an
  unreadable shard (on a mesh, on every rank when one rank's read
  fails); :meth:`~CheckpointManager.latest_step` and
  :meth:`~CheckpointManager.restore_latest` fall back to the newest step
  that verifies.
* **Elastic restore**: ``restore`` assembles each target leaf (the whole
  leaf, or this rank's block of it under ``shardings``) from the shards
  that overlap it, whatever mesh wrote them: a checkpoint restores onto
  another mesh shape or onto one device.
* **Restore in place**: the live tensors of the target tree are written
  with ``copy_`` under ``no_grad``, so whatever holds them (a train step,
  a packed-chain cache keyed on version counters) sees the restored
  values.  A manifest whose leaves, shapes or dtypes differ from the
  target's raises with the names; nothing is skipped or zero-filled.
* **Retention**: the ``keep`` newest steps are kept.

The directory is made by the first save, so a manager that never saves
leaves nothing on disk.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


IO_THREADS = 8  # shards hashed, and read and verified, at once


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step failed verification (a shard unreadable, missing
    or not matching its sha256)."""


def _leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(slash-joined path, leaf)`` of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):  # a NamedTuple (a Block) is a leaf
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _shard_fname(name: str, offset) -> str:
    return name.replace("/", "__") + "@" + "_".join(map(str, offset)) + ".npy"


def _sha256(data: np.ndarray) -> str:
    """sha256 of the array's raw bytes (the reference's ``tobytes()``
    digest, hashed from the buffer without a copy)."""
    return hashlib.sha256(np.ascontiguousarray(data).reshape(-1).view(np.uint8)).hexdigest()


def _host(leaf) -> tuple[np.ndarray, str]:
    """A private host copy of ``leaf`` and its dtype's name (bf16 as
    ``uint16`` bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf)
    return a, str(a.dtype)


def _tensor(data: np.ndarray, dtype: str) -> torch.Tensor:
    data = np.require(data, requirements="C")  # keeps 0-d arrays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(data)


def _offsets(shard_offset, shard_shape, block_offset, block_shape):
    """The overlap of a shard and a block of one leaf: the slices into
    the shard and into the block, or None when they do not meet."""
    src, dst = [], []
    for so, sn, bo, bn in zip(shard_offset, shard_shape, block_offset, block_shape):
        lo, hi = max(so, bo), min(so + sn, bo + bn)
        if lo >= hi:
            return None
        src.append(slice(lo - so, hi - so))
        dst.append(slice(lo - bo, hi - bo))
    return tuple(src), tuple(dst)


def _np_dtype(name: str):
    return np.uint16 if name == "bfloat16" else np.dtype(name)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None  # a failed background write
        self._pending: tuple | None = None  # on a mesh: (step, manifest) to finish in wait()
        self.last_write_s: float | None = None  # seconds the last finished write took

    def _writes(self, block) -> bool:
        """Whether this rank writes ``block``: the rank at coordinate 0 on
        every mesh axis the block is not split over."""
        if self.mesh is None:
            return True
        return all(self.mesh.coord[a] == 0 for a in self.mesh.axis_names if a not in (block.axes if block else ()))

    def _all_ok(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (a collective on a mesh)."""
        if self.mesh is None:
            return ok
        import torch.distributed as dist

        from repro_torch.distributed import mesh as _mesh

        flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=self.mesh.device)
        return bool(_mesh.all_reduce(flag, dist.group.WORLD, op=dist.ReduceOp.MIN)[0])

    # -- save -----------------------------------------------------------------

    def save_async(self, step: int, tree, extra: dict | None = None, shardings=None) -> dict:
        """Snapshot ``tree`` (a tree of dicts and lists of tensors or
        arrays) to host memory, hash it, and write step ``step`` on a
        background thread; ``shardings`` (on a mesh): the tree's
        :class:`Block` of each leaf on this rank.  Raises a failed earlier
        write first.  Returns ``{"bytes", "snapshot_s", "hash_s"}`` of the
        synchronous part (``bytes``: what this rank writes)."""
        self.wait()
        t0 = time.perf_counter()
        leaves = _leaves(tree)
        blocks = [b for _, b in _leaves(shardings)] if shardings is not None else [None] * len(leaves)
        items = []  # (name, offset, data, global shape, dtype)
        for (name, leaf), block in zip(leaves, blocks):
            if not self._writes(block):
                continue
            data, dtype = _host(leaf)
            offset = tuple(block.offset) if block is not None else (0,) * data.ndim
            shape = tuple(block.global_shape) if block is not None else data.shape
            items.append((name, offset, data, shape, dtype))
        t1 = time.perf_counter()
        with ThreadPoolExecutor(IO_THREADS) as pool:  # hashlib lets go of the GIL on large buffers
            digests = list(pool.map(_sha256, [data for _, _, data, _, _ in items]))
        records = [(name, list(shape), dtype, {"offset": list(offset), "shard_shape": list(data.shape),
                                               "sha256": digest})
                   for (name, offset, data, shape, dtype), digest in zip(items, digests)]
        t2 = time.perf_counter()
        if self.mesh is not None:
            import torch.distributed as dist

            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, records)
            records = [r for rank in gathered for r in rank]
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, _ in _leaves(tree):
            manifest["leaves"][name] = None  # the tree's order
        for name, shape, dtype, shard in records:
            manifest["leaves"][name] = manifest["leaves"][name] or {"shape": shape, "dtype": dtype, "shards": []}
            manifest["leaves"][name]["shards"].append(shard)
        tmp = os.path.join(self.dir, f"{step}.tmp")
        if self.mesh is not None:
            self._pending = (step, manifest)

        def write():
            try:
                t3 = time.perf_counter()
                os.makedirs(tmp, exist_ok=True)
                for name, offset, data, _, _ in items:  # one thread: the train loop runs on beside it
                    np.save(os.path.join(tmp, _shard_fname(name, offset)), data)
                if self.mesh is None:
                    self._finish(step, manifest)
                self.last_write_s = time.perf_counter() - t3
            except BaseException as e:  # noqa: BLE001 — re-raised from wait()
                self._exc = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return {"bytes": sum(d.nbytes for _, _, d, _, _ in items), "snapshot_s": t1 - t0, "hash_s": t2 - t1}

    def _finish(self, step: int, manifest: dict) -> None:
        """The manifest into ``<step>.tmp``, the step renamed into place,
        old steps removed."""
        tmp = os.path.join(self.dir, f"{step}.tmp")
        final = os.path.join(self.dir, str(step))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the background write; re-raise its exception if it failed
        (that step was then never renamed into place).  On a mesh, after
        every rank's write, rank 0 finishes the step (module docstring)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:
            step, manifest = self._pending
            self._pending = None
            ok = self._all_ok(self._exc is None)
            if ok and self.mesh.rank == 0:
                try:
                    self._finish(step, manifest)
                except BaseException as e:  # noqa: BLE001 — raised below
                    self._exc = e
            import torch.distributed as dist

            dist.barrier()
            if not ok and self._exc is None:
                raise RuntimeError(f"background checkpoint write of step {step} failed on another rank")
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("background checkpoint write failed") from exc
    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, str(s)), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d) for d in os.listdir(self.dir)
                      if d.isdigit() and os.path.exists(os.path.join(self.dir, d, "manifest.json")))

    def _manifest(self, step: int) -> dict:
        try:
            with open(os.path.join(self.dir, str(step), "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(f"step {step}: manifest unreadable: {e}") from e

    def _load(self, step: int, name: str, shard: dict) -> np.ndarray:
        fname = _shard_fname(name, shard["offset"])
        try:
            data = np.load(os.path.join(self.dir, str(step), fname))
        except Exception as e:  # noqa: BLE001 — any unreadable shard is corrupt
            raise CorruptCheckpointError(f"step {step}: shard {fname} unreadable: {e}") from e
        want = shard.get("sha256")
        if want is not None and _sha256(data) != want:
            raise CorruptCheckpointError(f"step {step}: shard {fname} sha256 mismatch (bit rot or torn write)")
        return data

    def verify(self, step: int) -> bool:
        """Whether ``step``'s manifest parses and every shard loads and
        matches its sha256 (a shard without one: loads)."""
        try:
            for name, meta in self._manifest(step)["leaves"].items():
                for s in meta["shards"]:
                    self._load(step, name, s)
        except (OSError, ValueError, KeyError, CorruptCheckpointError):
            return False
        return True

    def latest_step(self, verified: bool = True) -> int | None:
        """The newest step that verifies (``verified=False``: the newest
        on disk)."""
        steps = self.all_steps()
        if not verified:
            return steps[-1] if steps else None
        return next((s for s in reversed(steps) if self.verify(s)), None)

    def restore_latest(self, target, shardings=None):
        """:meth:`restore` of the newest step that restores intact:
        ``(target, extra, step)``, or ``(target, None, None)`` untouched
        when there is none."""
        for step in reversed(self.all_steps()):
            try:
                target, extra = self.restore(step, target, shardings)
            except CorruptCheckpointError:
                continue
            return target, extra, step
        return target, None, None

    def restore(self, step: int, target, shardings=None):
        """Write step ``step`` into the tensors of ``target`` in place;
        returns ``(target, extra)``.  The manifest's leaves must be
        exactly the target's, with the same global shapes and dtypes;
        ``shardings`` (on a mesh): the target's :class:`Block` of each leaf
        on this rank, each assembled from the shards that overlap it
        (without: each leaf whole).  Every shard is read and verified
        before any tensor is written."""
        manifest = self._manifest(step)
        meta = manifest["leaves"]
        leaves = _leaves(target)
        blocks = [b for _, b in _leaves(shardings)] if shardings is not None else [None] * len(leaves)
        names = [n for n, _ in leaves]
        missing = sorted(set(names) - set(meta))
        extra_names = sorted(set(meta) - set(names))
        if missing or extra_names:
            raise ValueError(f"step {step} does not hold this state: missing {missing[:8]}"
                             f"{' …' if len(missing) > 8 else ''}, unexpected {extra_names[:8]}"
                             f"{' …' if len(extra_names) > 8 else ''}")
        checked = []
        for (name, leaf), block in zip(leaves, blocks):
            m = meta[name]
            want = str(leaf.dtype).removeprefix("torch.")
            global_shape = tuple(block.global_shape) if block is not None else tuple(leaf.shape)
            if tuple(m["shape"]) != global_shape or m["dtype"] != want:
                raise ValueError(f"step {step}: {name} is {m['dtype']}{m['shape']} on disk, "
                                 f"{want}{list(global_shape)} in the target")
            checked.append((name, leaf, tuple(block.offset) if block is not None else (0,) * leaf.ndim))

        def assemble(item):
            """The leaf's block from the shards that overlap it, verified."""
            name, leaf, offset = item
            m = meta[name]
            buf = np.empty(tuple(leaf.shape), dtype=_np_dtype(m["dtype"]))
            covered = 0
            for shard in m["shards"]:
                cut = _offsets(shard["offset"], shard["shard_shape"], offset, buf.shape)
                if cut is None:
                    continue
                data = self._load(step, name, shard)
                buf[cut[1]] = data[cut[0]]
                covered += buf[cut[1]].size
            if covered != buf.size:
                raise CorruptCheckpointError(f"step {step}: the shards of {name} cover {covered} of {buf.size} entries")
            return leaf, _tensor(buf, m["dtype"])

        def attempt(item):
            try:
                return assemble(item), None
            except CorruptCheckpointError as e:
                return None, e

        with ThreadPoolExecutor(IO_THREADS) as pool:
            done = list(pool.map(attempt, checked))
        loaded = [pair for pair, _ in done if pair is not None]
        err = next((e for _, e in done if e is not None), None)
        if not self._all_ok(err is None):
            raise err or CorruptCheckpointError(f"step {step}: another rank's shards failed verification")
        with torch.no_grad():
            for leaf, t in loaded:
                leaf.copy_(t)
        return target, manifest["extra"]
