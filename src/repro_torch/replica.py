"""CacheDelta replication: one writer, N wait-free read replicas, in torch.

Port of `repro.replica`.  Every mutation of the engine commits a typed,
adjacency-diff-exact `core/closure_cache.CacheDelta`; this module ships it:

  * `Primary` — the single writer: a `DagEngine` session plus the
    append-only delta log.  Every mutator delegates to the engine and
    records ``LogEntry(epoch, grow_to, delta)``, where the delta's masks
    ARE the writer's accept decisions.
  * `Replica` — a reader: the (adjacency, packed closure) pair of one
    engine version, advanced by replaying the log through
    `closure_cache.apply_delta` — on the card the same kernels the writer
    commits with (B2 / B3 on the dense layout, B4 / B5 on the tiled one)
    — and NO reader-side cycle check.  Reads are closure bit lookups:
    zero boolean-matmul row products.
  * crash recovery = base image + tail: `ft/checkpoint` saves the engine
    (the epoch is a leaf, so the base image knows its version) and
    `recover_replica` replays every log entry past the base epoch.

The log crosses to the host as numpy arrays of the reference's dtypes
(int32 slots, bool masks), so `entry_crc` and the bytes `save_delta_log`
writes equal the reference's: either package replays the other's log
files.

Integrity: every shipped entry carries the epoch it extends
(``prev_epoch``) and a CRC32 over its metadata and delta, so a reader
detects corruption in transit (`CorruptLogError`), epoch gaps
(`ReplicaDiverged`, the resync trigger) and duplicate redelivery
(skipped).  On disk the log is framed, versioned and per-record
checksummed: `load_delta_log` truncates a torn tail to the last valid
entry and raises typed errors (file + byte offset) for mid-file
corruption, and `recover_replica` falls back to the newest uncorrupted
checkpoint.
"""
from __future__ import annotations

import io
import logging
import os
import struct
import zipfile
import zlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitset, closure_cache
from repro_torch.core import dag as dag_mod
from repro_torch.core.closure_cache import CacheDelta
from repro_torch.core.engine import DagEngine, OpResult, as_compiled

logger = logging.getLogger(__name__)


class CorruptLogError(RuntimeError):
    """A delta log (file or shipped entry) failed an integrity check.

    Carries the file path (None for an in-memory shipped entry) and the
    byte offset of the first bad byte region (-1 when not applicable)."""

    def __init__(self, detail: str, path: Optional[str] = None,
                 offset: int = -1):
        self.path = path
        self.offset = int(offset)
        where = ""
        if path is not None:
            where = f" [{path}" + (f" @ byte {offset}]" if offset >= 0
                                   else "]")
        super().__init__(detail + where)


class ReplicaDiverged(RuntimeError):
    """A replica cannot safely apply a log entry: the entry extends an
    epoch the replica never reached (dropped/reordered shipment, or a
    writer restart), or addresses slots beyond the replica's capacity (a
    missed grow entry).  Recover via `recover_replica` (base image +
    tail) or `Replica.resync` from a live engine."""

    def __init__(self, replica_epoch: int, entry_prev: int,
                 entry_epoch: int, detail: Optional[str] = None):
        self.replica_epoch = int(replica_epoch)
        self.entry_prev = int(entry_prev)
        self.entry_epoch = int(entry_epoch)
        msg = detail or (
            f"log entry for epoch {entry_epoch} extends epoch "
            f"{entry_prev}, but this replica is at epoch "
            f"{replica_epoch} — entries were dropped or reordered in "
            "shipping")
        super().__init__(
            msg + "; resync via recover_replica or Replica.resync")


class LogEntry(NamedTuple):
    """One shipped mutation: the engine epoch AFTER the commit, a grow
    marker (``grow_to > 0`` re-embeds the replica at that capacity before
    the delta applies; growth does not bump the epoch), the typed delta,
    the epoch this entry extends (``prev_epoch``, -1 = unknown) and
    `entry_crc` (0 = unchecksummed legacy entry)."""

    epoch: int
    grow_to: int
    delta: CacheDelta
    prev_epoch: int = -1
    crc: int = 0


def entry_crc(epoch: int, grow_to: int, prev_epoch: int,
              delta: CacheDelta) -> int:
    """CRC32 over an entry's metadata and every delta array's shape +
    bytes (host arrays).  Never returns 0, so ``crc == 0`` stays the "no
    checksum" sentinel on legacy entries."""
    h = zlib.crc32(np.asarray([int(epoch), int(grow_to),
                               int(prev_epoch)], np.int64).tobytes())
    for v in delta:
        a = np.ascontiguousarray(np.asarray(v))
        h = zlib.crc32(np.asarray(a.shape, np.int64).tobytes(), h)
        h = zlib.crc32(a.tobytes(), h)
    return (h & 0xFFFFFFFF) or 1


# the reference's host dtypes, field by field: int32 slots, bool masks
_HOST_DTYPES = tuple(np.bool_ if name.endswith("mask") else np.int32
                     for name in CacheDelta._fields)


def _host_delta(delta: CacheDelta) -> CacheDelta:
    """The delta as numpy arrays of the reference's dtypes, so the log
    survives the tensors it was cut from and serializes without the
    device.  Device tensors cross in ONE copy: the eight fields are
    concatenated as int32 on the device and split on the host."""
    if not any(isinstance(x, torch.Tensor) and x.device.type != "cpu"
               for x in delta):
        return CacheDelta(*[
            (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            .astype(dt, copy=False) for x, dt in zip(delta, _HOST_DTYPES)])
    dev = next(x.device for x in delta if isinstance(x, torch.Tensor))
    sizes = [int(np.prod(tuple(x.shape))) for x in delta]
    flat = torch.cat([torch.as_tensor(x, device=dev).reshape(-1)
                      .to(torch.int32) for x in delta]).cpu().numpy()
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return CacheDelta(*[p.reshape(tuple(x.shape)).astype(dt)
                        for p, x, dt in zip(parts, delta, _HOST_DTYPES)])


def _device_delta(delta: CacheDelta, device) -> CacheDelta:
    """A host delta as tensors on ``device`` (int32 slots, bool masks)."""
    return CacheDelta(*[
        torch.as_tensor(np.asarray(x), device=device).to(
            torch.bool if dt is np.bool_ else torch.int32)
        for x, dt in zip(delta, _HOST_DTYPES)])


def _max_slot(delta: CacheDelta) -> int:
    """Largest slot index the delta's MASKED rows address (-1 when the
    delta is empty) — the capacity a replica needs to apply it without
    the scatters silently dropping bits."""
    delta = _host_delta(delta)
    m = -1
    for slots, mask in ((delta.add_u, delta.add_mask),
                        (delta.add_v, delta.add_mask),
                        (delta.rem_u, delta.rem_mask),
                        (delta.rem_v, delta.rem_mask),
                        (delta.clear_slots, delta.clear_mask)):
        if slots.size and mask.any():
            m = max(m, int(slots[mask].max()))
    return m


def _has_adds(delta: CacheDelta) -> bool:
    return delta.add_u.shape[0] > 0


def _has_deletes(delta: CacheDelta) -> bool:
    return delta.rem_u.shape[0] > 0 or delta.clear_slots.shape[0] > 0


def _merge_deltas(deltas: Sequence[CacheDelta]) -> CacheDelta:
    """Concatenate a delete-side-before-add-side run of deltas into one.
    Exact because `closure_cache.apply_delta` applies the delete side
    first against the post-delta adjacency and folds the whole accepted
    add set last — the linearization the writer committed the run
    under.  Staged device deltas concatenate on the device, host deltas
    on the host."""
    if len(deltas) == 1:
        return deltas[0]
    if isinstance(deltas[0][0], torch.Tensor):
        return CacheDelta.merge(*deltas)
    return CacheDelta(*[np.concatenate([d[i] for d in deltas])
                        for i in range(len(CacheDelta._fields))])


def coalesce_entries(entries: Sequence[LogEntry]) -> List[LogEntry]:
    """Merge a recorded run of log entries into the fewest equivalent
    entries: consecutive deltas coalesce while every delete-recording
    entry precedes every add-recording entry (a front-end tick's phase
    order always qualifies, so one tick ships as ONE entry); a grow
    marker only ever opens a group.  Each merged entry carries the LAST
    epoch of its group and the FIRST entry's ``prev_epoch``."""
    groups: List[List[LogEntry]] = []
    for e in entries:
        if groups and e.grow_to == 0:
            g = groups[-1]
            adds_seen = any(_has_adds(x.delta) for x in g)
            if not (adds_seen and _has_deletes(e.delta)):
                g.append(e)
                continue
        groups.append([e])
    out = []
    for g in groups:
        merged = _merge_deltas([x.delta for x in g])
        out.append(LogEntry(g[-1].epoch, g[0].grow_to, merged,
                            g[0].prev_epoch))
    return out


# --------------------------------------------------- compiled writer steps
#
# The reference compiles each mutator and its delta into one XLA program.
# The port runs each inside `as_compiled`, as a jitted call runs: a tiled
# window does not widen and ``auto_grow`` reports instead of growing;
# `Primary.add_vertices` grows between calls itself.

def _add_vertices_step(engine, keys, valid):
    with as_compiled():
        return engine.add_vertices(keys, valid=valid)


def _add_edges_step(engine, us, vs, valid):
    with as_compiled():
        engine, res = engine.add_edges_acyclic(us, vs, valid=valid)
    u_slot, _ = dag_mod.lookup_slots(engine.state, us)
    v_slot, _ = dag_mod.lookup_slots(engine.state, vs)
    return engine, res, CacheDelta.edges_added(u_slot, v_slot, res.ok)


def _remove_edges_step(engine, us, vs, valid):
    with as_compiled():
        return engine.remove_edges_with_delta(us, vs, valid=valid)


def _remove_vertices_step(engine, keys, valid):
    with as_compiled():
        return engine.remove_vertices_with_delta(keys, valid=valid)


# ------------------------------------------------------------------ writer

class Primary:
    """The single writer: a `DagEngine` plus its replication log.

    Mutators mirror the engine's and return the `OpResult`;
    ``primary.engine`` is always the latest version.  Only the four
    single-op mutators and `grow` record log entries.

    Two hot-path modes (both off by default):

      * ``defer_flush=True`` keeps deltas on the device, and `flush()`
        ships them (one device->host copy an entry), coalescing
        phase-ordered same-tick runs into one `LogEntry`;
      * ``jit=True`` runs each mutator inside `as_compiled`, as the
        reference runs its compiled steps.
    """

    def __init__(self, engine: DagEngine,
                 log: Optional[List[LogEntry]] = None, *,
                 defer_flush: bool = False, jit: bool = False,
                 fault_plan=None):
        self.engine = engine
        self.log: List[LogEntry] = list(log) if log is not None else []
        # fault injection hook (ft/faults.FaultPlan): `flush` consults
        # plan.crash_index to crash mid-ship, leaving a durable prefix
        self.fault_plan = fault_plan
        self.defer_flush = bool(defer_flush)
        self.jit = bool(jit)
        self._staged: List[LogEntry] = []

    @classmethod
    def create(cls, capacity: int, *, defer_flush: bool = False,
               jit: bool = False, fault_plan=None, **options) -> "Primary":
        """A fresh writer; ``options`` mirror `DagEngine.create`."""
        return cls(DagEngine.create(capacity, **options),
                   defer_flush=defer_flush, jit=jit, fault_plan=fault_plan)

    @property
    def epoch(self) -> int:
        return self.engine.epoch

    def _record(self, delta: CacheDelta, grow_to: int = 0,
                bumped: bool = True) -> None:
        # prev_epoch = the epoch this entry extends: mutators bumped the
        # engine (prev = epoch - 1), grow did not (prev = epoch)
        epoch = self.engine.epoch
        prev = epoch - 1 if bumped else epoch
        if self.defer_flush:
            # the delta stays on the device; the crc is computed at flush
            # time, where the host copy happens
            self._staged.append(LogEntry(epoch, grow_to, delta, prev))
        else:
            host = _host_delta(delta)
            crc = entry_crc(epoch, grow_to, prev, host)
            self.log.append(LogEntry(epoch, grow_to, host, prev, crc))

    def flush(self, coalesce: bool = True) -> List[LogEntry]:
        """Ship every staged delta to the host log.

        With ``coalesce`` (default) same-tick runs merge into one
        `LogEntry` via `coalesce_entries`.  Returns the entries appended
        (empty when nothing is staged).  Entries ship one at a time so an
        injected crash (`fault_plan`) leaves a durable prefix in
        ``self.log``; the unshipped remainder is lost."""
        if not self._staged:
            return []
        staged, self._staged = self._staged, []
        groups = coalesce_entries(staged) if coalesce else staged
        crash_at = None
        if self.fault_plan is not None:
            crash_at = self.fault_plan.crash_index(
                len(groups), site="Primary.flush")
        shipped: List[LogEntry] = []
        for i, e in enumerate(groups):
            if crash_at is not None and i == crash_at:
                from repro_torch.ft.faults import InjectedCrash
                raise InjectedCrash(
                    f"injected crash in Primary.flush before entry {i} "
                    f"of {len(groups)} (FaultPlan seed "
                    f"{self.fault_plan.seed}); {i} entries shipped "
                    "durably, the rest are lost")
            epoch, grow_to = int(e.epoch), int(e.grow_to)
            prev = int(e.prev_epoch)
            host = _host_delta(e.delta)
            entry = LogEntry(epoch, grow_to, host, prev,
                             entry_crc(epoch, grow_to, prev, host))
            self.log.append(entry)
            shipped.append(entry)
        return shipped

    # ------------------------------------------------------- mutators

    def _keys(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32,
                               device=self.engine.device)

    def _valid(self, keys: torch.Tensor, valid) -> torch.Tensor:
        if valid is None:
            return torch.ones(keys.shape, dtype=torch.bool,
                              device=keys.device)
        return torch.as_tensor(valid, dtype=torch.bool, device=keys.device)

    def add_vertices(self, keys, valid=None) -> OpResult:
        cap_before = self.engine.capacity
        keys = self._keys(keys)
        valid = None if valid is None and not self.jit \
            else self._valid(keys, valid)
        if self.jit:
            eng, res = _add_vertices_step(self.engine, keys, valid)
            # auto_grow cannot fire inside the step; mirror the eager
            # engine here: double until the dropped adds fit, re-run on
            # the grown pre-call engine
            while self.engine.config.auto_grow and \
                    int(res.n_overflow) > int(self.engine.state.n_overflow):
                grown = self.engine.grow(2 * self.engine.capacity)
                self.engine = grown
                eng, res = _add_vertices_step(grown, keys, valid)
            self.engine = eng
        else:
            self.engine, res = self.engine.add_vertices(keys, valid=valid)
        # auto_grow may have re-run the call on a grown engine; ship the
        # capacity so the replica's slab grows in the same place
        grow_to = self.engine.capacity \
            if self.engine.capacity != cap_before else 0
        self._record(CacheDelta.empty(self.engine.device), grow_to=grow_to)
        return res

    def add_edges_acyclic(self, us, vs, valid=None) -> OpResult:
        us, vs = self._keys(us), self._keys(vs)
        if self.jit:
            self.engine, res, delta = _add_edges_step(
                self.engine, us, vs, self._valid(us, valid))
        else:
            self.engine, res = self.engine.add_edges_acyclic(
                us, vs, valid=None if valid is None
                else self._valid(us, valid))
            # the delta's mask IS the accept decision: ok rows exist in
            # the post-graph (folding a present edge is an exact no-op)
            u_slot, _ = dag_mod.lookup_slots(self.engine.state, us)
            v_slot, _ = dag_mod.lookup_slots(self.engine.state, vs)
            delta = CacheDelta.edges_added(u_slot, v_slot, res.ok)
        self._record(delta)
        return res

    def remove_edges(self, us, vs, valid=None) -> OpResult:
        us, vs = self._keys(us), self._keys(vs)
        if self.jit:
            self.engine, res, delta = _remove_edges_step(
                self.engine, us, vs, self._valid(us, valid))
        else:
            self.engine, res, delta = self.engine.remove_edges_with_delta(
                us, vs, valid=None if valid is None
                else self._valid(us, valid))
        self._record(delta)
        return res

    def remove_vertices(self, keys, valid=None) -> OpResult:
        keys = self._keys(keys)
        if self.jit:
            self.engine, res, delta = _remove_vertices_step(
                self.engine, keys, self._valid(keys, valid))
        else:
            self.engine, res, delta = \
                self.engine.remove_vertices_with_delta(
                    keys, valid=None if valid is None
                    else self._valid(keys, valid))
        self._record(delta)
        return res

    def grow(self, new_capacity: int) -> None:
        self.engine = self.engine.grow(new_capacity)
        # growth does not bump the epoch: this entry extends the CURRENT
        # epoch, not epoch - 1
        self._record(CacheDelta.empty(self.engine.device),
                     grow_to=new_capacity, bumped=False)

    # ---------------------------------------------------------- reads

    def snapshot(self):
        """The latest `EngineSnapshot` (see `DagEngine.snapshot`)."""
        return self.engine.snapshot()

    def checkpoint(self, directory: str, step: Optional[int] = None) -> str:
        """Write the base image (atomic engine checkpoint; the epoch leaf
        names where the log tail starts).  Default step: the current
        epoch.  Staged deltas flush first so the base aligns with a
        shipped log boundary."""
        self.flush()
        from repro_torch.ft import checkpoint as ckpt
        return ckpt.save_engine_checkpoint(
            directory, self.epoch if step is None else step, self.engine)


# ------------------------------------------------------------------ reader

def _same_bits(a, b) -> bool:
    """Whether two closures (dense or tiled, any windows) hold the same
    bits, as `torch.equal` of their `dense_of` says, without densifying
    two tiled closures: the capacities must agree, the common window
    must agree and every bit of the wider window past it must be 0."""
    if not (closure_cache.is_tiled(a) and closure_cache.is_tiled(b)):
        return torch.equal(closure_cache.dense_of(a),
                           closure_cache.dense_of(b))
    if a.capacity != b.capacity:
        return False
    if a.region > b.region:
        a, b = b, a
    r, wr = a.tiles.shape
    return (torch.equal(a.tiles, b.tiles[:r, :wr])
            and not bool(torch.any(b.tiles[r:]))
            and not bool(torch.any(b.tiles[:r, wr:])))


class Replica:
    """A wait-free read replica: (epoch, adjacency mirror, packed closure).

    Immutable — `apply` returns a new replica; reads are closure bit
    lookups.  ``update_impl`` / ``delete_impl`` are the kernel overrides
    the engine takes; None (the default) runs the `kernels.ops`
    dispatchers, so a replica on the card launches B2 / B3 (dense) or
    B4 / B5 (tiled).
    """

    __slots__ = ("epoch", "adj", "closure", "update_impl", "delete_impl")

    def __init__(self, epoch: int, adj: torch.Tensor, closure,
                 update_impl=None, delete_impl=None):
        set_ = object.__setattr__
        set_(self, "epoch", int(epoch))  # version this replica is at
        set_(self, "adj", adj)            # int32[C, W]: adjacency mirror
        # strict closure mirror: dense int32[C, W] slab or a
        # closure_cache.TiledClosure (the primary's layout)
        set_(self, "closure", closure)
        set_(self, "update_impl", update_impl)
        set_(self, "delete_impl", delete_impl)

    def __setattr__(self, name, value):
        raise AttributeError("Replica is immutable; apply() returns a new "
                             "one")

    def __repr__(self):
        return f"Replica(epoch={self.epoch}, capacity={self.capacity})"

    @property
    def capacity(self) -> int:
        return self.adj.shape[0]

    @property
    def device(self) -> torch.device:
        return self.adj.device

    # --------------------------------------------------- construction

    @classmethod
    def from_snapshot(cls, snap, update_impl=None,
                      delete_impl=None) -> "Replica":
        """Start from an `EngineSnapshot` (shares its tensors)."""
        return cls(snap.epoch, snap.state.adj, snap.closure,
                   update_impl, delete_impl)

    @classmethod
    def from_engine(cls, engine: DagEngine, update_impl=None,
                    delete_impl=None) -> "Replica":
        """Start from a live (or just-restored) engine — e.g. the base
        image of a crash recovery."""
        return cls.from_snapshot(engine.snapshot(), update_impl,
                                 delete_impl)

    def _with(self, epoch: int, adj: torch.Tensor, closure) -> "Replica":
        return Replica(epoch, adj, closure, self.update_impl,
                       self.delete_impl)

    # ----------------------------------------------------- delta apply

    def _grown(self, new_capacity: int) -> "Replica":
        c, w = self.adj.shape
        if new_capacity <= c:
            return self
        adj = torch.nn.functional.pad(
            self.adj, (0, bitset.n_words(new_capacity) - w,
                       0, new_capacity - c))
        return self._with(self.epoch, adj, closure_cache.grow_closure(
            self.closure, new_capacity))

    def _windowed(self, need_slots: int) -> "Replica":
        """Tiled closures: widen the tile window to confine slots up to
        ``need_slots`` before a delta touches them (host-side, doubling as
        `DagEngine._pre_widened` does).  Dense: no-op."""
        if not closure_cache.is_tiled(self.closure):
            return self
        region = self.closure.region
        if need_slots <= region:
            return self
        nr = closure_cache.align_region(
            max(2 * region, need_slots), self.capacity)
        return self._with(self.epoch, self.adj,
                          closure_cache.grow_region(self.closure, nr))

    def _adj_after(self, delta: CacheDelta) -> torch.Tensor:
        """The adjacency mirror after ``delta`` (device tensors): removes,
        vertex clears, then adds — the commit linearization."""
        adj = self.adj
        c = adj.shape[0]
        if delta.rem_u.shape[0]:
            adj = bitset.scatter_clear_bits(adj, delta.rem_u, delta.rem_v,
                                            delta.rem_mask)
        if delta.clear_slots.shape[0]:
            slots = delta.clear_slots
            # slot c is the drop target of masked-out rows
            cleared = torch.zeros((c + 1,), dtype=torch.bool,
                                  device=adj.device)
            cleared[torch.where(delta.clear_mask & (slots >= 0)
                                & (slots < c), slots, c).long()] = True
            cleared = cleared[:c]
            adj = torch.where(cleared[:, None], 0, adj)
            adj = adj & ~bitset.pack_bits(cleared)[None, :]
        if delta.add_u.shape[0]:
            adj = bitset.scatter_set_bits(adj, delta.add_u, delta.add_v,
                                          delta.add_mask)
        return adj

    def _admits(self, entry: LogEntry) -> bool:
        """Integrity + ordering gate for one entry (host side).

        Returns True -> apply it, False -> already reflected here (a
        duplicate or recovery-boundary redelivery: SKIP).  Raises
        `CorruptLogError` on a checksum mismatch and `ReplicaDiverged` on
        an epoch gap or a delta addressing slots past this replica's
        capacity (a missed grow entry)."""
        if int(entry.crc):
            host = _host_delta(entry.delta)
            want = int(entry.crc)
            got = entry_crc(int(entry.epoch), int(entry.grow_to),
                            int(entry.prev_epoch), host)
            if got != want:
                raise CorruptLogError(
                    f"log entry for epoch {int(entry.epoch)} failed its "
                    f"CRC32 check (stored {want:#010x}, computed "
                    f"{got:#010x}) — payload corrupted in transit")
        ep = self.epoch
        e_ep, prev = int(entry.epoch), int(entry.prev_epoch)
        if prev >= 0 and prev > ep:
            raise ReplicaDiverged(ep, prev, e_ep)
        if e_ep <= ep:
            return False
        cap = max(self.capacity, int(entry.grow_to))
        mx = _max_slot(entry.delta)
        if mx >= cap:
            raise ReplicaDiverged(
                ep, prev, e_ep,
                detail=f"log entry for epoch {e_ep} addresses slot {mx} "
                       f"beyond capacity {cap} — a grow entry is missing "
                       "from the shipment")
        return True

    def _applied(self, epoch: int, delta: CacheDelta) -> "Replica":
        """This replica advanced by ``delta`` (host arrays) to ``epoch``:
        no grow, no window widening."""
        delta = _device_delta(delta, self.device)
        adj = self._adj_after(delta)
        closure = closure_cache.apply_delta(
            self.closure, adj, delta, update_impl=self.update_impl,
            delete_impl=self.delete_impl)
        return self._with(int(epoch), adj, closure)

    def apply(self, entry: LogEntry, verify: bool = True) -> "Replica":
        """Apply one log entry -> the replica at ``entry.epoch``.

        No cycle check, no dispatch: the delta's masks carry the
        primary's decisions.  With ``verify`` (default) the entry first
        passes `_admits` (a skipped grow entry still re-embeds)."""
        if verify and not self._admits(entry):
            return self._grown(int(entry.grow_to)) if entry.grow_to \
                else self
        rep = self._grown(int(entry.grow_to)) if entry.grow_to else self
        rep = rep._windowed(_max_slot(entry.delta) + 1)
        return rep._applied(entry.epoch, entry.delta)

    def replay(self, entries: Sequence[LogEntry],
               verify: bool = True) -> "Replica":
        """Replay a log tail.  Entries at or below this replica's epoch
        skip safely inside `apply`; gaps and corruption raise typed
        errors when ``verify``."""
        rep = self
        for e in entries:
            rep = rep.apply(e, verify=verify)
        return rep

    def resync(self, engine: DagEngine) -> "Replica":
        """A fresh replica at ``engine``'s current version, keeping this
        replica's kernel overrides."""
        return Replica.from_engine(engine, self.update_impl,
                                   self.delete_impl)

    # ---------------------------------------------------------- reads

    def reachable_slots(self, u_slots, v_slots) -> torch.Tensor:
        """Batch PathExists over slots — one closure bit read per query,
        zero matmul products."""
        dev = self.device
        return closure_cache.closure_bit_get(
            self.closure, torch.as_tensor(u_slots, dtype=torch.int32,
                                          device=dev),
            torch.as_tensor(v_slots, dtype=torch.int32, device=dev))

    def converged_with(self, engine: DagEngine) -> bool:
        """True iff this replica's adjacency AND closure equal the
        engine's, bit for bit (the engine's cache is re-cleaned first).
        Layouts may differ: the bits are compared."""
        eng = engine.refresh_cache()
        return torch.equal(self.adj, eng.state.adj) and \
            _same_bits(self.closure, eng.cache.closure)


# ------------------------------------------------------------ log on disk
#
# Framed v2 format, byte-compatible with the reference's:
#
#   header:  8-byte magic | uint32 version | uint32 crc32(magic+version)
#   record:  uint32 payload_len | uint32 crc32(payload) | payload
#   payload: npz of meta=[epoch, grow_to, prev_epoch, crc] + delta arrays
#
# A record cut at EOF (or whose trailing checksum fails) is a torn tail and
# loads truncate to the last valid entry; a checksum failure with more
# records after it is mid-file corruption and raises `CorruptLogError`
# naming the file and byte offset.  v1 (a plain npz) still loads.

LOG_MAGIC = b"NBDAGLOG"
LOG_VERSION = 2
SUPPORTED_LOG_VERSIONS = (1, 2)
_LOG_HEADER = struct.Struct("<8sI")   # magic, version (then uint32 crc)
_LOG_RECORD = struct.Struct("<II")    # payload_len, crc32(payload)


def save_delta_log(path: str, entries: Sequence[LogEntry]) -> str:
    """Serialize a delta log (framed v2, atomic rename) — the
    incremental tail next to the checkpoint base image."""
    chunks = []
    header = _LOG_HEADER.pack(LOG_MAGIC, LOG_VERSION)
    chunks.append(header + struct.pack("<I", zlib.crc32(header)))
    for e in entries:
        delta = _host_delta(e.delta)
        epoch, grow_to = int(e.epoch), int(e.grow_to)
        prev = int(e.prev_epoch)
        crc = int(e.crc) or entry_crc(epoch, grow_to, prev, delta)
        buf = io.BytesIO()
        np.savez(buf,
                 meta=np.asarray([epoch, grow_to, prev, crc], np.int64),
                 **dict(zip(CacheDelta._fields, delta)))
        payload = buf.getvalue()
        chunks.append(_LOG_RECORD.pack(len(payload), zlib.crc32(payload))
                      + payload)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(b"".join(chunks))
    os.replace(tmp, path)
    return path


def _entry_from_payload(payload: bytes) -> LogEntry:
    data = np.load(io.BytesIO(payload))
    epoch, grow_to, prev, crc = (int(x) for x in data["meta"])
    delta = CacheDelta(*[data[name] for name in CacheDelta._fields])
    return LogEntry(epoch, grow_to, delta, prev, crc)


def _load_legacy_v1(path: str) -> List[LogEntry]:
    """The v1 plain-npz log: no framing, no checksums — any zip-level
    damage is unlocalizable, so errors wrap into `CorruptLogError` at
    offset 0."""
    try:
        data = np.load(path)
        out = []
        for i in range(int(data["n_entries"])):
            epoch, grow_to = (int(x) for x in data[f"e{i}_meta"])
            delta = CacheDelta(*[data[f"e{i}_{name}"]
                                 for name in CacheDelta._fields])
            out.append(LogEntry(epoch, grow_to, delta))
        return out
    except (OSError, KeyError, ValueError, EOFError,
            zipfile.BadZipFile, zlib.error) as err:
        raise CorruptLogError(
            f"legacy v1 delta log is truncated or corrupt ({err!r}); "
            "v1 has no per-entry framing, so no valid prefix can be "
            "salvaged — recover from the checkpoint base image alone",
            path=path, offset=0) from err


def load_delta_log(path: str, strict: bool = False) -> List[LogEntry]:
    """Load a delta log, verifying the framing checksums.

    A torn tail truncates to the last valid entry (logged, or raised when
    ``strict``); corruption BEFORE the final record raises
    `CorruptLogError` with the file and byte offset.  An unsupported
    format version raises with the nearest supported version named."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"PK":  # legacy v1: a bare npz (zip) file
        return _load_legacy_v1(path)
    if len(data) < _LOG_HEADER.size + 4:
        raise CorruptLogError(
            f"file is {len(data)} bytes — shorter than a delta-log "
            "header", path=path, offset=0)
    magic, version = _LOG_HEADER.unpack_from(data, 0)
    (header_crc,) = struct.unpack_from("<I", data, _LOG_HEADER.size)
    if magic != LOG_MAGIC:
        raise CorruptLogError(
            f"bad magic {magic!r} — not a delta log (expected "
            f"{LOG_MAGIC!r}, or zip magic for a legacy v1 npz)",
            path=path, offset=0)
    if zlib.crc32(data[:_LOG_HEADER.size]) != header_crc:
        raise CorruptLogError("header failed its CRC32 check",
                              path=path, offset=0)
    if version != LOG_VERSION:
        nearest = min(SUPPORTED_LOG_VERSIONS,
                      key=lambda v: abs(v - version))
        hint = " (v1 logs are plain npz files, loaded transparently)" \
            if nearest == 1 else ""
        raise CorruptLogError(
            f"unsupported log format version {version}; nearest "
            f"supported version is {nearest}{hint}", path=path, offset=8)
    out: List[LogEntry] = []
    off = _LOG_HEADER.size + 4
    end = len(data)
    while off < end:
        torn = None
        if off + _LOG_RECORD.size > end:
            torn = f"record header cut short at byte {off}"
            length = crc = None
        else:
            length, crc = _LOG_RECORD.unpack_from(data, off)
            payload = data[off + _LOG_RECORD.size:
                           off + _LOG_RECORD.size + length]
            if len(payload) < length:
                torn = (f"entry {len(out)} payload cut short "
                        f"({len(payload)} of {length} bytes)")
            elif zlib.crc32(payload) != crc:
                if off + _LOG_RECORD.size + length >= end:
                    torn = (f"entry {len(out)} (the final record) "
                            "failed its CRC32 check")
                else:
                    raise CorruptLogError(
                        f"entry {len(out)} failed its CRC32 check with "
                        "more records after it — mid-file corruption, "
                        "not a torn write", path=path,
                        offset=off + _LOG_RECORD.size)
        if torn is not None:
            msg = (f"torn write: {torn}; truncating to {len(out)} "
                   "valid entries")
            if strict:
                raise CorruptLogError(msg, path=path, offset=off)
            logger.warning("%s: %s", path, msg)
            break
        try:
            out.append(_entry_from_payload(payload))
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile) as err:
            raise CorruptLogError(
                f"entry {len(out)} passed its checksum but failed to "
                f"decode ({err!r})", path=path,
                offset=off + _LOG_RECORD.size) from err
        off += _LOG_RECORD.size + length
    return out


def recover_replica(checkpoint_dir: str, like: DagEngine,
                    entries: Sequence[LogEntry],
                    step: Optional[int] = None, update_impl=None,
                    delete_impl=None) -> "Replica":
    """Crash recovery: restore the base image under ``like``
    (`ft/checkpoint.restore_engine_checkpoint`, on ``like``'s device; a
    base saved at a smaller capacity grows forward), then replay the log
    tail from the base's own epoch.

    With ``step=None`` the NEWEST checkpoint whose arrays pass their
    manifest CRC32 is the base; a corrupt one logs a warning and recovery
    falls back to the next-older step.  An explicit ``step`` is trusted
    as given (its errors propagate)."""
    from repro_torch.ft import checkpoint as ckpt
    if step is not None:
        base = ckpt.restore_engine_checkpoint(checkpoint_dir, like,
                                              step=step)
    else:
        steps = ckpt.all_steps(checkpoint_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        base = None
        errors = []
        for s in reversed(steps):  # newest first
            try:
                base = ckpt.restore_engine_checkpoint(checkpoint_dir,
                                                      like, step=s)
                break
            except ckpt.CorruptCheckpointError as err:
                logger.warning(
                    "checkpoint step %d is corrupt (%s); falling back "
                    "to the next-older base image", s, err)
                errors.append(err)
        if base is None:
            raise ckpt.CorruptCheckpointError(
                f"all {len(steps)} checkpoints in {checkpoint_dir} "
                "failed integrity checks; no valid base image") \
                from errors[-1]
    rep = Replica.from_engine(base, update_impl=update_impl,
                              delete_impl=delete_impl)
    return rep.replay(entries)
