"""Asynchronous, verified checkpoints.  Counterpart of
:mod:`repro.checkpoint.manager`, with the same on-disk format.

* **Layout**: one directory per step.  Each leaf of the saved tree is one
  ``.npy`` shard file named ``<name>@<offset>.npy`` (``/`` in the name
  becomes ``__``), and ``manifest.json`` records every leaf's shape, dtype
  and shards (offset, shard shape, sha256) with the caller's ``extra``.
  On one GPU every leaf is one shard at offset 0; the mesh's sharded
  layout (``shardings=``) comes with the multi-GPU slice and raises.
* **Dtypes**: bf16 is stored as its ``uint16`` bits with ``"bfloat16"``
  as the manifest's dtype (numpy has no bfloat16).
* **Atomicity**: a step is written to ``<step>.tmp`` and renamed after
  its manifest lands, so a crash mid-write never leaves a half step.
* **Async**: :meth:`CheckpointManager.save_async` copies every leaf to
  host memory and hashes it (synchronously: the hash is of the exact
  bytes handed to the writer), then writes on a background thread.  A
  failed background write is re-raised from :meth:`~CheckpointManager.wait`
  and from the next save, never lost in the thread.
* **Integrity**: :meth:`~CheckpointManager.restore` re-hashes every shard
  and raises :class:`CorruptCheckpointError` on a mismatch or an
  unreadable shard; :meth:`~CheckpointManager.latest_step` and
  :meth:`~CheckpointManager.restore_latest` fall back to the newest step
  that verifies.
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

import numpy as np
import torch


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
    if isinstance(tree, (list, tuple)):
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


def _no_mesh(shardings) -> None:
    if shardings is not None:
        raise NotImplementedError("sharded checkpoints (shardings=) come with the multi-GPU slice of the port")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None  # a failed background write
        self.last_write_s: float | None = None  # seconds the last finished write took

    # -- save -----------------------------------------------------------------

    def save_async(self, step: int, tree, extra: dict | None = None, shardings=None) -> dict:
        """Snapshot ``tree`` (a tree of dicts and lists of tensors or
        arrays) to host memory, hash it, and write step ``step`` on a
        background thread.  Raises a failed earlier write first.  Returns
        ``{"bytes", "snapshot_s", "hash_s"}`` of the synchronous part."""
        _no_mesh(shardings)
        self.wait()
        t0 = time.perf_counter()
        items = [(name, *_host(leaf)) for name, leaf in _leaves(tree)]
        t1 = time.perf_counter()
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, data, dtype in items:
            offset = [0] * data.ndim
            manifest["leaves"][name] = {
                "shape": list(data.shape), "dtype": dtype,
                "shards": [{"offset": offset, "shard_shape": list(data.shape), "sha256": _sha256(data)}],
            }
        t2 = time.perf_counter()

        def write():
            try:
                t3 = time.perf_counter()
                tmp = os.path.join(self.dir, f"{step}.tmp")
                final = os.path.join(self.dir, str(step))
                os.makedirs(tmp, exist_ok=True)
                for name, data, _ in items:
                    np.save(os.path.join(tmp, _shard_fname(name, (0,) * data.ndim)), data)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
                self.last_write_s = time.perf_counter() - t3
            except BaseException as e:  # noqa: BLE001 — re-raised from wait()
                self._exc = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return {"bytes": sum(d.nbytes for _, d, _ in items), "snapshot_s": t1 - t0, "hash_s": t2 - t1}

    def wait(self) -> None:
        """Join the background write; re-raise its exception if it failed
        (that step was then never renamed into place)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
        with open(os.path.join(self.dir, str(step), "manifest.json")) as f:
            return json.load(f)

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
        """:meth:`restore` of the newest intact step: ``(target, extra,
        step)``, or ``(target, None, None)`` untouched when there is none."""
        step = self.latest_step()
        if step is None:
            return target, None, None
        target, extra = self.restore(step, target, shardings)
        return target, extra, step

    def restore(self, step: int, target, shardings=None):
        """Write step ``step`` into the tensors of ``target`` in place;
        returns ``(target, extra)``.  The manifest's leaves must be
        exactly the target's, with the same shapes and dtypes, one shard a
        leaf; every shard is read and verified before any tensor is
        written."""
        _no_mesh(shardings)
        manifest = self._manifest(step)
        meta = manifest["leaves"]
        leaves = _leaves(target)
        names = [n for n, _ in leaves]
        missing = sorted(set(names) - set(meta))
        extra_names = sorted(set(meta) - set(names))
        if missing or extra_names:
            raise ValueError(f"step {step} does not hold this state: missing {missing[:8]}"
                             f"{' …' if len(missing) > 8 else ''}, unexpected {extra_names[:8]}"
                             f"{' …' if len(extra_names) > 8 else ''}")
        loaded = []
        for name, leaf in leaves:
            m = meta[name]
            want = str(leaf.dtype).removeprefix("torch.")
            if tuple(m["shape"]) != tuple(leaf.shape) or m["dtype"] != want:
                raise ValueError(f"step {step}: {name} is {m['dtype']}{m['shape']} on disk, "
                                 f"{want}{list(leaf.shape)} in the target")
            if len(m["shards"]) != 1:
                raise NotImplementedError(f"step {step}: {name} is sharded {len(m['shards'])} ways; "
                                          "sharded checkpoints come with the multi-GPU slice of the port")
            loaded.append((leaf, _tensor(self._load(step, name, m["shards"][0]), m["dtype"])))
        with torch.no_grad():
            for leaf, t in loaded:
                leaf.copy_(t)
        return target, manifest["extra"]
