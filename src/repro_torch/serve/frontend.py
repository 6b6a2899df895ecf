"""Asyncio serving front-end: many client streams, one coalesced writer.

Port of `repro.serve.frontend`.  The reference's jitted read paths run
here inside `core.engine.as_compiled`, its compiled replica apply is
`_advance_replica` (which skips the window widening), and the padded
phase tensors live on the writer engine's device (the card unless
`Frontend.create` is given ``device``).

The paper's concurrency is "many threads mutate/query one acyclic graph
without blocking"; in this reproduction the batch dimension B *is* that
concurrency.  This module finally fills B from real concurrent clients:

  * clients `submit` typed requests (insert-edge / remove / reachability,
    tagged with a tenant id) into a bounded multi-tenant queue;
  * a coalescer task drains the queue into the engine's typed batches —
    it waits for up to ``batch_size`` requests but never past
    ``max_wait_s`` (low load must not stall), picks the B slots with
    deficit-round-robin over tenants (`fairness.DeficitRoundRobin`), and
    commits one padded fixed-shape tick through the single `Primary`
    writer in the documented linearization order (RemoveVertex,
    AddVertex, RemoveEdge, AddEdge, then reads);
  * reads are answered by versioned readers, never the mutation path:
    reader="snapshot" takes one frozen `EngineSnapshot` per mutated tick,
    reader="replica" replays the tick's coalesced `LogEntry` into N
    `Replica`s and rotates reads across them — both answer in closure
    bit lookups, zero reader-side boolean-matmul row-products;
  * `admission.AdmissionController` sheds at the two pressure points:
    queue-full submits reject immediately, and per-call ``n_overflow``
    backpressure either 429s exactly the dropped vertex adds (policy
    "shed") or rides the engine's ``auto_grow`` doubling (policy "grow").

Fixed shapes: every phase pads to ``batch_size`` with a ``valid`` mask, so
every tick launches the same work whatever way the queue filled.

The front-end records its commit-order linearization in ``trace`` —
(kind, a, b, ok) per applied request — which is the hook for the
bit-for-bit equivalence property in tests/test_serve_frontend.py: the
same trace replayed as one sequential stream must reproduce every accept
decision and the final adjacency/closure exactly.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import time
from typing import Deque, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dag as dag_mod
from repro_torch.core.dispatch import validate_choice
from repro_torch.core.engine import DagEngine, as_compiled
from repro_torch.replica import (CorruptLogError, LogEntry, Primary, Replica,
                                 ReplicaDiverged)
from repro_torch.serve.admission import AdmissionController, ReplicaHealth
from repro_torch.serve.fairness import DeficitRoundRobin

logger = logging.getLogger(__name__)


class FrontendClosed(RuntimeError):
    """`submit` on a front-end that is not serving — never started, or
    already stopped.  Raised immediately instead of enqueueing into a
    loop that will never tick (the request's future would hang forever).
    Subclasses RuntimeError for drop-in compatibility."""

KINDS = ("add_vertex", "remove_vertex", "add_edge", "remove_edge",
         "reachable")
READERS = ("snapshot", "replica")

STATUS_OK = 200
STATUS_SHED = 429

# the read paths, run as the reference runs its jitted ones


def _snap_take(e: DagEngine):
    with as_compiled():
        return e.snapshot()


def _snap_read(s, f, t, m) -> torch.Tensor:
    return s.reachable(f, t) & m


def _slot_lookup(e: DagEngine, k: torch.Tensor):
    return dag_mod.lookup_slots(e.state, k)


def _rep_read(r: Replica, u, v, m) -> torch.Tensor:
    return r.reachable_slots(u, v) & m


def _advance_replica(rep: Replica, entries: List[LogEntry]) -> Replica:
    """Replay semantics of `Replica.replay` as the reference's compiled
    apply runs them: the same host-side integrity gate (`Replica._admits`
    — CRC verify, epoch-gap detection, duplicate skip), then the delta
    apply minus the window widening: a compiled call cannot widen, so
    this loop calls `Replica._applied` and never `Replica._windowed`.
    Raises `ReplicaDiverged` / `CorruptLogError` exactly like `replay`;
    the front-end turns those into a resync from the live engine."""
    for e in entries:
        if not rep._admits(e):
            if e.grow_to:
                rep = rep._grown(int(e.grow_to))
            continue
        if e.grow_to:
            rep = rep._grown(e.grow_to)
        rep = rep._applied(e.epoch, e.delta)
    return rep


@dataclasses.dataclass
class Request:
    kind: str
    a: int
    b: int
    tenant: Hashable
    future: Optional[asyncio.Future]
    t_submit: float


@dataclasses.dataclass(frozen=True)
class Response:
    """What a client's `submit` resolves to.

    ``ok`` is the engine's accept bit (mutations) or the query answer
    (reads); ``status`` is 200 for a served request and 429 for a shed
    one (queue full, or a vertex add the slab overflowed under policy
    "shed" — ``ok`` is False there and the graph is untouched).

    ``read_epoch`` is the engine version the answer was computed at —
    the staleness contract: mutations and healthy reads answer at the
    tick's ``epoch`` (``read_epoch == epoch``), while a degraded read
    (every replica down) falls back to a frozen snapshot and reports
    the snapshot's older version, so ``stale`` is True and the client
    knows exactly how far behind its answer is."""

    ok: bool
    status: int
    epoch: int
    tick: int
    read_epoch: int = -1

    @property
    def stale(self) -> bool:
        """Served correctly, but at a version older than the tick's."""
        return self.status == STATUS_OK and 0 <= self.read_epoch < self.epoch


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs of the coalescer; validated at `Frontend` construction."""

    batch_size: int = 64        # B: slots per coalesced tick
    max_wait_s: float = 0.002   # deadline: never hold a request longer
    queue_depth: int = 4096     # bound on queued-not-yet-served requests
    admission: str = "shed"     # "shed" 429s overflow, "grow" auto-grows
    reader: str = "snapshot"    # "snapshot" | "replica"
    replicas: int = 2           # replica count when reader="replica"
    tenant_weights: Optional[Dict[Hashable, float]] = None
    quantum: float = 1.0        # DRR credit per rotation per unit weight
    # --- degraded-read path (reader="replica"): a replica advance that
    # exceeds the timeout retries in-tick, then the replica backs off
    # exponentially (ReplicaHealth); reads fall back to a frozen
    # snapshot no more than max_staleness epochs behind the engine
    replica_timeout_s: float = 1.0   # per-advance wall-clock budget
    replica_max_retries: int = 2     # in-tick retries before backoff
    replica_backoff_ticks: int = 4   # initial backoff (doubles, cap 64)
    max_staleness: int = 64          # epoch bound on fallback answers


class Frontend:
    """The serving front-end around one `Primary` writer.

    Usage::

        fe = Frontend.create(1024)
        async with fe:
            resp = await fe.submit("add_edge", 3, 7, tenant="alice")
    """

    def __init__(self, primary: Primary,
                 config: FrontendConfig = FrontendConfig(), *,
                 fault_plan=None):
        validate_choice(config.reader, READERS, what="reader")
        if config.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {config.batch_size}")
        if config.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {config.max_wait_s}")
        if config.reader == "replica" and config.replicas < 1:
            raise ValueError('reader="replica" needs replicas >= 1, got '
                             f"{config.replicas}")
        if config.replica_timeout_s <= 0:
            raise ValueError("replica_timeout_s must be > 0, got "
                             f"{config.replica_timeout_s}")
        if config.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {config.max_staleness}")
        if config.admission == "grow" and \
                not primary.engine.config.auto_grow:
            raise ValueError(
                'admission="grow" turns overflow into growth, which needs '
                "an auto_grow=True engine (create the Primary with "
                "auto_grow=True, or use admission=\"shed\")")
        self.primary = primary
        self.config = config
        self.admission = AdmissionController(config.admission,
                                             config.queue_depth)
        self.drr = DeficitRoundRobin(config.tenant_weights, config.quantum)
        self._pending: Dict[Hashable, Deque[Request]] = {}
        self._n_queued = 0
        self._running = False
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wakeup: Optional[asyncio.Event] = None
        self._tick_no = 0
        self._closed = False
        self._warmup_active = False
        self._log_cursor = len(primary.log)
        self._snap = primary.snapshot()
        self._replicas: List[Replica] = []
        self._health: List[ReplicaHealth] = []
        if config.reader == "replica":
            self._replicas = [Replica.from_engine(primary.engine)
                              for _ in range(config.replicas)]
            self._health = [
                ReplicaHealth(config.replica_max_retries,
                              config.replica_backoff_ticks)
                for _ in range(config.replicas)]
        # fault injection (ft/faults.FaultPlan): perturbs the entries
        # shipped to each replica and injects advance stalls — the
        # health/backoff/resync machinery under test is the real one
        self._fault_plan = fault_plan
        # commit-order linearization of every APPLIED request — the
        # sequential-equivalence oracle replays exactly this
        self.trace: List[Tuple[str, int, int, bool]] = []
        self.n_served = 0
        self.n_resyncs = 0
        self.n_degraded_reads = 0
        self.served_by_tenant: Dict[Hashable, int] = {}

    @classmethod
    def create(cls, capacity: int,
               config: FrontendConfig = FrontendConfig(),
               method: str = "incremental", fault_plan=None,
               device=None, **engine_opts) -> "Frontend":
        """A front-end around a fresh writer on ``device`` (None: the
        card) in its hot-path modes: deferred/coalesced log flush + the
        mutator steps run as compiled calls.

        The engine is created with ``subbatches=batch_size`` — the
        fully-sequential zero-false-positive edge-insert mode — so a
        coalesced tick decides exactly like the same requests applied
        one at a time.  The paper's joint-abort mode (``subbatches=1``)
        would let two same-tick edges on one cycle BOTH abort, which
        breaks the front-end's sequential-equivalence contract (the
        ``trace`` oracle); callers who want paper semantics anyway can
        pass ``subbatches=1`` explicitly."""
        if config.admission == "grow":
            engine_opts.setdefault("auto_grow", True)
        # max(1, ...) so an invalid batch_size still reaches the
        # constructor's own "batch_size must be >= 1" error below
        engine_opts.setdefault("subbatches", max(1, config.batch_size))
        eng = DagEngine.create(capacity, method=method, device=device,
                               **engine_opts)
        return cls(Primary(eng, defer_flush=True, jit=True), config,
                   fault_plan=fault_plan)

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> "Frontend":
        if self._running:
            return self
        self._loop = asyncio.get_running_loop()
        self._wakeup = asyncio.Event()
        self._running = True
        self._closed = False
        self._task = self._loop.create_task(self._serve_loop())
        return self

    async def stop(self) -> None:
        """Drain the queue (every admitted request gets its response),
        then stop the coalescer and flush the log tail."""
        self._closed = True
        if not self._running and self._task is None:
            return
        self._running = False
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            await self._task
            self._task = None
        self.primary.flush()
        self._log_cursor = len(self.primary.log)

    async def __aenter__(self) -> "Frontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -------------------------------------------------------------- submit

    async def submit(self, kind: str, a: int, b: int = 0,
                     tenant: Hashable = "default") -> Response:
        """Enqueue one typed request; resolves when its tick commits.

        429s immediately (without enqueueing) when the bounded queue is
        full.  Keys are non-negative ints — the engine's EMPTY sentinel
        is negative and padded slots must stay distinguishable."""
        validate_choice(kind, KINDS, what="request kind")
        if not self._running:
            # a clean typed error, immediately — enqueueing here would
            # park the future in a loop that will never tick
            if self._closed:
                raise FrontendClosed(
                    "frontend is closed (stop() completed) and not "
                    "running — it will never tick; start() it again or "
                    "create a new one")
            raise FrontendClosed("frontend is not running — use "
                                 "`async with frontend:` or await start()")
        if a < 0 or b < 0:
            raise ValueError(f"keys must be >= 0, got ({a}, {b})")
        if not self.admission.admit(self._n_queued):
            return Response(False, STATUS_SHED, -1, self._tick_no)
        fut = self._loop.create_future()
        req = Request(kind, int(a), int(b), tenant, fut,
                      time.perf_counter())
        self._pending.setdefault(tenant, collections.deque()).append(req)
        self._n_queued += 1
        self._wakeup.set()
        return await fut

    # ----------------------------------------------------------- coalescer

    async def _serve_loop(self) -> None:
        cfg = self.config
        loop = self._loop
        while True:
            if self._n_queued == 0:
                if not self._running:
                    break
                self._wakeup.clear()
                if self._n_queued == 0:  # nothing raced in before clear
                    await self._wakeup.wait()
                continue
            # coalesce: fill B from the queue, never wait past deadline
            deadline = loop.time() + cfg.max_wait_s
            while self._n_queued < cfg.batch_size and self._running:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), remaining)
                except asyncio.TimeoutError:
                    break
            batch = self.drr.select(self._pending, cfg.batch_size)
            self._n_queued -= len(batch)
            if not batch:
                continue
            # the device work runs in a worker thread so the event loop
            # keeps admitting submissions while the device computes
            results = await loop.run_in_executor(None, self._commit_sync,
                                                 batch)
            for req, resp in results:
                if req.future is not None and not req.future.done():
                    req.future.set_result(resp)
            self._tick_no += 1

    # ---------------------------------------------------------- the tick

    def _pad(self, reqs: List[Request]):
        """(a[B], b[B], valid[B]) — fixed-shape padded phase arrays."""
        B = self.config.batch_size
        a = np.zeros(B, np.int32)
        b = np.zeros(B, np.int32)
        m = np.zeros(B, bool)
        for i, r in enumerate(reqs):
            a[i], b[i], m[i] = r.a, r.b, True
        dev = self.primary.engine.device
        return (torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                torch.as_tensor(m, device=dev))

    def _commit_sync(self, batch: List[Request]
                     ) -> List[Tuple[Request, Response]]:
        p = self.primary
        by_kind: Dict[str, List[Request]] = {k: [] for k in KINDS}
        for r in batch:
            by_kind[r.kind].append(r)
        out: List[Tuple[Request, Response]] = []
        # (req, ok, status) in COMMIT order — the trace must record the
        # linearization the engine actually applied, or the sequential
        # oracle replays same-tick dependent ops out of order
        decisions: List[Tuple[Request, bool, int]] = []
        rv, av = by_kind["remove_vertex"], by_kind["add_vertex"]
        re_, ae = by_kind["remove_edge"], by_kind["add_edge"]
        mutated = bool(rv or av or re_ or ae)

        # ---- writer phases, in the engine's linearization order.  A
        # mutated tick runs ALL FOUR phases (empty ones fully masked
        # out), as the reference's does: every tick coalesces to the same
        # shapes — one coalesced-delta shape for the replica replay.
        # Reads-only ticks skip the writer entirely. ----
        if mutated:
            keys, _, m = self._pad(rv)
            ok = p.remove_vertices(keys, valid=m).ok.cpu().numpy()
            decisions += [(r, bool(ok[i]), STATUS_OK)
                          for i, r in enumerate(rv)]
            keys, _, m = self._pad(av)
            res = p.add_vertices(keys, valid=m)
            ok = res.ok.cpu().numpy()
            shed = self.admission.overflow_shed(ok, m.cpu().numpy())
            decisions += [(r, bool(ok[i]),
                           STATUS_SHED if shed[i] else STATUS_OK)
                          for i, r in enumerate(av)]
            us, vs, m = self._pad(re_)
            ok = p.remove_edges(us, vs, valid=m).ok.cpu().numpy()
            decisions += [(r, bool(ok[i]), STATUS_OK)
                          for i, r in enumerate(re_)]
            us, vs, m = self._pad(ae)
            ok = p.add_edges_acyclic(us, vs, valid=m).ok.cpu().numpy()
            decisions += [(r, bool(ok[i]), STATUS_OK)
                          for i, r in enumerate(ae)]

        # ---- ship the tick's log (ONE coalesced entry, one host copy)
        # and advance the readers to this version ----
        if mutated:
            p.flush()
            if self._replicas:
                new = p.log[self._log_cursor:]
                for i in range(len(self._replicas)):
                    self._advance_one(i, new)
            self._log_cursor = len(p.log)
            if self.config.reader == "snapshot":
                self._snap = _snap_take(p.engine)

        epoch = p.engine.epoch

        # ---- reads, answered at the tick's frozen version; with every
        # replica down, degrade to a stale-but-correct snapshot and
        # report its older version on the Response ----
        reads = by_kind["reachable"]
        read_ok = None
        read_epoch = epoch
        if reads:
            f, t, m = self._pad(reads)
            rep = None if self.config.reader == "snapshot" \
                else self._pick_replica(epoch)
            if rep is not None:
                # rotate the tick's read batch across replicas; the
                # router resolves keys to slots off the writer's table
                # (replicas are slot-addressed on purpose — see replica.py)
                fs, ff = _slot_lookup(p.engine, f)
                ts, tf = _slot_lookup(p.engine, t)
                read_ok = _rep_read(rep, fs, ts, m & ff & tf).cpu().numpy()
            else:
                if self.config.reader != "snapshot":
                    # degraded: the snapshot answers at ITS epoch —
                    # frozen and consistent, just possibly behind
                    self._snap = self._fallback_snap(epoch)
                    self.n_degraded_reads += len(reads)
                read_ok = _snap_read(self._snap, f, t, m).cpu().numpy()
                read_epoch = int(self._snap.epoch)

        tick = self._tick_no

        def respond(req: Request, ok: bool, status: int,
                    at_epoch: int = epoch) -> None:
            out.append((req, Response(ok, status, epoch, tick, at_epoch)))
            if status == STATUS_OK:
                self.trace.append((req.kind, req.a, req.b, ok))
                self.n_served += 1
                self.served_by_tenant[req.tenant] = \
                    self.served_by_tenant.get(req.tenant, 0) + 1

        for req, ok, status in decisions:
            respond(req, ok, status)
        for i, req in enumerate(reads):
            respond(req, bool(read_ok[i]), STATUS_OK, read_epoch)
        return out

    # ------------------------------------------- replica health machinery

    def _advance_one(self, i: int, entries: List[LogEntry]) -> None:
        """Advance replica ``i`` by the tick's entries under the health
        policy: skip while backing off, bounded in-tick retries on a
        timed-out advance, and an immediate resync from the live engine
        on divergence or corruption.  A replica that exhausts its
        retries is marked down; when its backoff expires, the epoch gap
        it accumulated trips `ReplicaDiverged` on the next advance and
        it resyncs — stale state never serves."""
        h = self._health[i]
        tick = self._tick_no
        if not h.available(tick):
            return
        plan = None if self._warmup_active else self._fault_plan
        ship = entries
        if plan is not None:
            ship, _ = plan.perturb_entries(entries,
                                           site=f"frontend.replica[{i}]")
        for attempt in range(self.config.replica_max_retries + 1):
            t0 = time.perf_counter()
            if plan is not None:
                plan.maybe_stall(site=f"frontend.replica[{i}]"
                                      f".advance(attempt={attempt})")
            try:
                rep = _advance_replica(self._replicas[i], ship)
            except (ReplicaDiverged, CorruptLogError) as err:
                h.n_diverged += 1
                self._resync(i, reason=str(err))
                return
            elapsed = time.perf_counter() - t0
            if self._warmup_active or \
                    elapsed <= self.config.replica_timeout_s:
                self._replicas[i] = rep
                h.record_success()
                return
            # too slow: a stalled advance did not produce its result in
            # budget — discard it and retry (the stall may be transient)
            h.record_timeout()
        backoff = h.mark_down(tick)
        logger.warning(
            "replica %d timed out %d times advancing tick %d; down for "
            "%d ticks", i, self.config.replica_max_retries + 1, tick,
            backoff)

    def _resync(self, i: int, reason: str) -> None:
        """Rebuild replica ``i`` from the live engine (self-healing):
        divergence is detected, never served."""
        self._replicas[i] = self._replicas[i].resync(self.primary.engine)
        self._health[i].record_resync()
        self.n_resyncs += 1
        logger.warning("replica %d resynced from the live engine: %s",
                       i, reason)

    def _pick_replica(self, epoch: int) -> Optional[Replica]:
        """The tick's reader: rotate across replicas that are healthy
        AND at the tick's epoch; None when every replica is down or
        behind (the caller degrades to the snapshot fallback)."""
        n = len(self._replicas)
        tick = self._tick_no
        for k in range(n):
            i = (tick + k) % n
            if self._health[i].available(tick) and \
                    int(self._replicas[i].epoch) == epoch:
                return self._replicas[i]
        return None

    def _fallback_snap(self, epoch: int):
        """The degraded-read snapshot, refreshed from the live engine
        only when more than ``max_staleness`` epochs behind — bounded
        staleness without paying a snapshot per healthy tick."""
        if epoch - int(self._snap.epoch) > self.config.max_staleness:
            self._snap = _snap_take(self.primary.engine)
        return self._snap

    # ------------------------------------------------------------- helpers

    def warmup(self) -> None:
        """Run every phase once at the serving shapes, then restore the
        pre-warmup state — benchmarks call this so the kernels' build and
        load stay out of the timed window.  Fault injection and the
        advance timeout are suspended for the pass: the first advance
        pays the build, which must not read as a stalled replica."""
        saved = (self.primary.engine, len(self.primary.log),
                 list(self.primary._staged), self._snap,
                 list(self._replicas), self._log_cursor, len(self.trace),
                 self.n_served, dict(self.served_by_tenant),
                 self.admission.n_shed_overflow, self.n_resyncs,
                 self.n_degraded_reads)
        batch = [Request(k, 0, 0, "_warmup", None, 0.0)
                 for k in ("remove_vertex", "add_vertex", "remove_edge",
                           "add_edge", "reachable")]
        self._warmup_active = True
        try:
            self._commit_sync(batch)
        finally:
            self._warmup_active = False
        (self.primary.engine, n_log, staged, self._snap, self._replicas,
         self._log_cursor, n_trace, self.n_served, self.served_by_tenant,
         self.admission.n_shed_overflow, self.n_resyncs,
         self.n_degraded_reads) = saved
        del self.primary.log[n_log:]
        self.primary._staged = staged
        del self.trace[n_trace:]

    @property
    def queue_depth_now(self) -> int:
        return self._n_queued

    @property
    def stats(self) -> dict:
        return {"ticks": self._tick_no, "n_served": self.n_served,
                "served_by_tenant": dict(self.served_by_tenant),
                "epoch": int(self.primary.engine.epoch),
                "n_resyncs": self.n_resyncs,
                "n_degraded_reads": self.n_degraded_reads,
                "replica_health": [h.stats for h in self._health],
                **self.admission.stats}
