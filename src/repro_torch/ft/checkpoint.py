"""Fault-tolerant checkpointing: atomic, optionally async, grow-on-restore.

Port of `repro.ft.checkpoint`.  Layout: <dir>/step_<N>/ { manifest.json,
arrays.npz }.  Atomicity: write into ``step_<N>.tmp`` then ``os.rename``
(POSIX-atomic), so a crash mid-write never corrupts the latest
checkpoint — restart scans for the highest complete step.  Async mode
hands the host-copied leaves to a writer thread so the caller does not
block on disk.

The port has no pytree.  A checkpointed tree is a `DagEngine` (its
leaves are `interop.LEAVES` / `TILED_LEAVES`, in the reference's flatten
order: ``keys`` first, ``epoch`` last), a dict of arrays or tensors (its
values in insertion order) or a list / tuple of them.  An engine's packed
words are written as ``uint32`` and its EMAs as float32, the reference's
dtypes, so equal leaves give a byte-identical ``arrays.npz`` (``np.savez``
writes a fixed zip timestamp) and a manifest with the same shapes, dtypes,
CRC32 and leaf count: each package restores the other's checkpoints.
Restore places the leaves on the ``like`` engine's (or tensor's) device.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import shutil
import threading
import zipfile
import zlib
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import closure_cache
from repro_torch.core.engine import DagEngine

# engine leaves holding packed words: int32 in the port, uint32 on disk
_PACKED = ("adj", "cache.closure", "cache.closure.tiles",
           "cache.closure.summary")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed an integrity check on restore: its
    ``arrays.npz`` bytes don't match the manifest's CRC32 (bit rot, a
    torn write that beat the atomic rename), or the manifest/arrays are
    unreadable.  `repro_torch.replica.recover_replica` treats this as
    "skip this base image, fall back to an older step"."""


class _Flat(NamedTuple):
    names: tuple      # one name per leaf
    leaves: list      # numpy arrays, host copies
    dtypes: list      # the leaves' dtype names before storage casts
    treedef: str


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _to_np(x) -> np.ndarray:
    # npz cannot hold bfloat16: it is stored as float32 (exact) and the
    # restore casts back through the template
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def engine_leaves(engine: DagEngine) -> dict:
    """The engine's leaves as numpy arrays in the reference's flatten
    order and dtypes (packed words ``uint32``)."""
    arrays = interop.engine_to_arrays(engine)
    tiled = closure_cache.is_tiled(engine.cache.closure)
    names = interop.TILED_LEAVES if tiled else interop.LEAVES
    return {n: arrays[n].view(np.uint32) if n in _PACKED else arrays[n]
            for n in names}


def _flatten(tree) -> _Flat:
    if isinstance(tree, _Flat):
        return tree
    if isinstance(tree, DagEngine):
        leaves = engine_leaves(tree)
        return _Flat(tuple(leaves), list(leaves.values()),
                     [str(a.dtype) for a in leaves.values()],
                     f"DagEngine({', '.join(leaves)})")
    if isinstance(tree, dict):
        names, values = tuple(tree), list(tree.values())
    else:
        names, values = tuple(str(i) for i in range(len(tree))), list(tree)
    kind = type(tree).__name__
    return _Flat(names, [_to_np(v) for v in values],
                 [_dtype_name(v) for v in values],
                 f"{kind}({', '.join(names)})")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": a for i, a in enumerate(flat.leaves)}
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **arrays)
    with open(arrays_path, "rb") as f:
        arrays_crc = zlib.crc32(f.read()) & 0xFFFFFFFF
    manifest = {
        "step": step,
        "n_leaves": len(flat.leaves),
        "treedef": flat.treedef,
        "dtypes": flat.dtypes,
        "shapes": [list(a.shape) for a in flat.leaves],
        # CRC32 of the arrays.npz bytes: restore verifies before
        # deserializing, so bit rot surfaces as CorruptCheckpointError
        "crc32": arrays_crc,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        os.rename(final, final + ".old")
    os.rename(tmp, final)
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def all_steps(directory: str) -> List[int]:
    """Every complete checkpoint step, ascending — `recover_replica`
    walks this newest-first to find the newest UNcorrupted base image."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and not name.endswith(".old"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def _verified_arrays(path: str):
    """Load ``<path>/arrays.npz`` after checking its bytes against the
    manifest CRC32 (when present; checkpoints without one load
    unverified).  Typed errors, never raw zipfile tracebacks."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise CorruptCheckpointError(
            f"manifest unreadable at {manifest_path}: {err!r}") from err
    arrays_path = os.path.join(path, "arrays.npz")
    try:
        with open(arrays_path, "rb") as f:
            raw = f.read()
    except OSError as err:
        raise CorruptCheckpointError(
            f"arrays unreadable at {arrays_path}: {err!r}") from err
    want = manifest.get("crc32")
    if want is not None:
        got = zlib.crc32(raw) & 0xFFFFFFFF
        if got != int(want):
            raise CorruptCheckpointError(
                f"{arrays_path} failed its CRC32 check (manifest "
                f"{int(want):#010x}, computed {got:#010x}) — corrupt "
                "base image; recovery should fall back to an older step")
    try:
        return np.load(io.BytesIO(raw))
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as err:
        raise CorruptCheckpointError(
            f"{arrays_path} is not a readable npz ({err!r})") from err


def _step_path(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return os.path.join(directory, f"step_{step:08d}")


def _leaf_arrays(path: str, n: int) -> list:
    data = _verified_arrays(path)
    try:
        return [data[f"leaf_{i}"] for i in range(n)]
    except KeyError as err:
        raise CorruptCheckpointError(
            f"{path} is missing leaf arrays ({err!r}); the checkpoint "
            "does not match the target structure") from err


def _like_leaf(a: np.ndarray, like):
    """``a`` cast to the template leaf's dtype, on its device."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(a).astype(like.dtype)
    return a


def _engine_restored(path: str, config) -> DagEngine:
    """The engine saved at ``path``, under ``config`` (whose capacity and
    layout must be the saved ones), on ``config.device``."""
    tiled = config.closure_layout == "tiled"
    names = interop.TILED_LEAVES if tiled else interop.LEAVES
    arrays = dict(zip(names, _leaf_arrays(path, len(names))))
    if tiled:
        config = dataclasses.replace(
            config, closure_region=int(arrays["cache.closure.tiles"].shape[0]))
    return interop.engine_of_leaves(arrays, config)


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure of ``like`` (a `DagEngine`, a dict, a
    list or tuple of leaves), each leaf cast to the template leaf's dtype
    and placed on its device.  The arrays are CRC32-verified against the
    manifest before deserializing; a mismatch raises
    `CorruptCheckpointError`."""
    path = _step_path(directory, step)
    if isinstance(like, DagEngine):
        return _engine_restored(path, like.config)
    if isinstance(like, dict):
        leaves = _leaf_arrays(path, len(like))
        return {k: _like_leaf(a, v)
                for (k, v), a in zip(like.items(), leaves)}
    leaves = _leaf_arrays(path, len(like))
    return type(like)(_like_leaf(a, v) for a, v in zip(leaves, like))


def save_engine_checkpoint(directory: str, step: int, engine) -> str:
    """Checkpoint a whole `DagEngine` session: its leaves are the full
    session state — adjacency slab, key table, overflow counter, the
    deciding-depth EMA, the closure cache with its dirty flag and
    repair-depth EMA, and the mutation epoch — so the checkpoint is a
    self-describing replication base image: `repro_torch.replica.
    recover_replica` restores it and replays the `CacheDelta` log tail
    from the saved epoch onward."""
    return save_checkpoint(directory, step, engine)


def _engine_manifest(directory: str, step: Optional[int]) -> Optional[dict]:
    """The manifest dict of an engine checkpoint, or None if unreadable."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _saved_capacity(directory: str, step: Optional[int]) -> Optional[int]:
    """Capacity a checkpoint was saved at: leaf 0 of an engine is
    ``state.keys`` (int32[C]), so the manifest's first shape names it."""
    manifest = _engine_manifest(directory, step)
    try:
        return int(manifest["shapes"][0][0])
    except (TypeError, KeyError, IndexError, ValueError):
        return None


def restore_engine_checkpoint(directory: str, like: DagEngine,
                              step: Optional[int] = None) -> DagEngine:
    """Restore a `DagEngine` session under ``like``'s configuration (its
    policy, kernel hooks and device; the config is not serialized).

    A checkpoint saved at capacity ``C`` also restores into a ``like``
    engine of capacity ``C' >= C``: the leaves are restored at the saved
    capacity and migrated up through `DagEngine.grow`.  The closure
    layout is read off the manifest (a tiled engine has one leaf more:
    tiles + summary instead of the dense slab), and the checkpoint
    restores across layouts through `DagEngine.with_closure_layout`."""
    saved = _saved_capacity(directory, step)
    if saved is None:
        return restore_checkpoint(directory, like, step=step)
    if saved > like.capacity:
        raise ValueError(
            f"checkpoint capacity {saved} exceeds the target engine's "
            f"{like.capacity}; restore into an engine of capacity >= "
            f"{saved}")
    manifest = _engine_manifest(directory, step)
    like_tiled = closure_cache.is_tiled(like.cache.closure)
    saved_tiled = int(manifest.get("n_leaves", len(interop.LEAVES))) \
        == len(interop.LEAVES) + 1
    if saved == like.capacity and saved_tiled == like_tiled:
        return restore_checkpoint(directory, like, step=step)
    # restore in the SAVED capacity and layout, then migrate up (grow)
    # and across (with_closure_layout) to match ``like``
    cfg = dataclasses.replace(
        like.config, capacity=saved,
        closure_layout="tiled" if saved_tiled else "dense",
        closure_region=0)
    grown = _engine_restored(_step_path(directory, step), cfg)
    if saved != like.capacity:
        grown = grown.grow(like.capacity)
    if saved_tiled != like_tiled:
        grown = grown.with_closure_layout(
            "tiled" if like_tiled else "dense",
            region=like.config.closure_region)
    return grown


class CheckpointManager:
    """Async checkpointing with bounded queue + keep-last-k retention."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next save/finalize
                self._err = e

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and "." not in n)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any):
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        host_tree = _flatten(tree)  # host copies, taken now
        if self.async_write:
            self._q.put((step, host_tree))
        else:
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

    def finalize(self):
        if self.async_write:
            self._q.put(None)
            self._thread.join(timeout=120)
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
