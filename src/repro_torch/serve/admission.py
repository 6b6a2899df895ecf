"""Admission control for the serving front-end.

Port of `repro.serve.admission` (framework-free: a copy).

Two pressure points, one controller:

  * at SUBMIT time, a bounded queue: a request arriving at a full queue
    is rejected immediately (429-style, never enqueued) — open-loop
    overload cannot grow the queue without bound;
  * at COMMIT time, the engine's own ``n_overflow`` backpressure
    signal: a vertex add the slab had no free slot for comes back
    ``ok=False`` with the overflow counter bumped.  Policy "shed" turns
    exactly those dropped adds into 429 responses (the graph is
    unchanged for them — the un-shedded oracle decides identically on
    the surviving stream); policy "grow" pairs with an
    ``auto_grow=True`` engine, which doubles capacity and retries, so
    nothing sheds and the 429 budget is spent on queue depth alone.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dispatch import validate_choice

ADMISSION_POLICIES = ("shed", "grow")


class AdmissionController:
    """Queue-depth gate + overflow-shed classifier, with counters."""

    def __init__(self, policy: str = "shed", queue_depth: int = 4096):
        validate_choice(policy, ADMISSION_POLICIES, what="admission policy")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.policy = policy
        self.queue_depth = int(queue_depth)
        self.n_admitted = 0
        self.n_shed_queue = 0
        self.n_shed_overflow = 0

    def admit(self, n_queued: int) -> bool:
        """Submit-time gate: False -> reject now, nothing was enqueued."""
        if n_queued >= self.queue_depth:
            self.n_shed_queue += 1
            return False
        self.n_admitted += 1
        return True

    def overflow_shed(self, ok, valid) -> np.ndarray:
        """bool[B]: which rows of a committed vertex-add phase to 429.

        A valid vertex add only comes back ``ok=False`` when the slab
        overflowed (re-adding a live key is ok=True), so under "shed"
        the shed set is exactly ``valid & ~ok`` — the requests the
        engine already dropped.  Under "grow" the engine grew and
        retried instead, so nothing sheds."""
        valid = np.asarray(valid, bool)
        if self.policy == "grow":
            return np.zeros_like(valid)
        shed = valid & ~np.asarray(ok, bool)
        self.n_shed_overflow += int(shed.sum())
        return shed

    @property
    def stats(self) -> dict:
        return {"policy": self.policy, "queue_depth": self.queue_depth,
                "n_admitted": self.n_admitted,
                "n_shed_queue": self.n_shed_queue,
                "n_shed_overflow": self.n_shed_overflow}


class ReplicaHealth:
    """Per-replica health for the front-end's degraded-read path.

    The front-end advances each replica per tick with a wall-clock
    timeout and ``max_retries`` in-tick retries; a replica that still
    can't advance is marked down for an exponentially growing number of
    ticks (``backoff_ticks * 2^round``, capped).  A down replica serves
    no reads; when its backoff expires the next advance naturally trips
    the log's epoch-gap detection (`ReplicaDiverged`) and the front-end
    resyncs it from the live engine — gap detection IS the resync
    trigger, no separate catch-up protocol."""

    def __init__(self, max_retries: int = 2, backoff_ticks: int = 4,
                 max_backoff_ticks: int = 64):
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}")
        if backoff_ticks < 1 or max_backoff_ticks < backoff_ticks:
            raise ValueError(
                "need 1 <= backoff_ticks <= max_backoff_ticks, got "
                f"({backoff_ticks}, {max_backoff_ticks})")
        self.max_retries = int(max_retries)
        self.backoff_ticks = int(backoff_ticks)
        self.max_backoff_ticks = int(max_backoff_ticks)
        self.down_until = -1   # first tick this replica may serve again
        self.rounds = 0        # consecutive mark_down()s (backoff expo)
        self.n_timeouts = 0
        self.n_diverged = 0
        self.n_resyncs = 0

    def available(self, tick: int) -> bool:
        return tick >= self.down_until

    def record_success(self) -> None:
        self.rounds = 0

    def record_timeout(self) -> None:
        self.n_timeouts += 1

    def mark_down(self, tick: int) -> int:
        """Back off; returns how many ticks this replica sits out."""
        backoff = min(self.backoff_ticks * (2 ** self.rounds),
                      self.max_backoff_ticks)
        self.rounds += 1
        self.down_until = tick + backoff
        return backoff

    def record_resync(self) -> None:
        self.n_resyncs += 1
        self.rounds = 0
        self.down_until = -1

    @property
    def stats(self) -> dict:
        return {"down_until": self.down_until, "rounds": self.rounds,
                "n_timeouts": self.n_timeouts,
                "n_diverged": self.n_diverged,
                "n_resyncs": self.n_resyncs}
