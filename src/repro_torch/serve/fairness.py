"""Per-tenant fairness: deficit round-robin over batch slots.

Port of `repro.serve.fairness` (framework-free: a copy).

The batch dimension B is the shared resource of the serving front-end —
every coalesced tick carries exactly B request slots into the engine.
`DeficitRoundRobin` decides which queued requests fill them, so one hot
tenant flooding the queue cannot monopolize B: each rotation credits
every backlogged tenant ``quantum * weight`` slots of deficit and serves
requests while the deficit covers them (cost 1 per request), so long-run
slot shares converge to the weight ratio and every backlogged tenant is
visited at least once per rotation (no starvation).

Two departures from classic packet DRR, both deliberate:

  * an idle tenant's deficit resets to zero — bursty tenants do not bank
    credit while away and then lock the batch on return;
  * the rotation cursor survives across `select` calls, resuming AT the
    tenant the batch boundary cut off — a tenant near the end of the
    ring is first in line next tick instead of starving behind refilled
    earlier queues.
"""
from __future__ import annotations

from typing import Deque, Dict, Hashable, List, Mapping, Optional, TypeVar

T = TypeVar("T")


class DeficitRoundRobin:
    """Pop up to ``n_slots`` requests per `select` across per-tenant FIFO
    queues, weight-proportionally.  Unknown tenants join the rotation in
    arrival order with weight 1.0."""

    def __init__(self, weights: Optional[Mapping[Hashable, float]] = None,
                 quantum: float = 1.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        weights = dict(weights or {})
        bad = {t: w for t, w in weights.items() if w <= 0}
        if bad:
            raise ValueError(f"tenant weights must be > 0, got {bad}")
        self.quantum = float(quantum)
        self._weights: Dict[Hashable, float] = weights
        self._deficit: Dict[Hashable, float] = {}
        self._ring: List[Hashable] = []
        self._cursor = 0

    def weight(self, tenant: Hashable) -> float:
        return float(self._weights.get(tenant, 1.0))

    def select(self, pending: Mapping[Hashable, Deque[T]],
               n_slots: int) -> List[T]:
        """Drain up to ``n_slots`` items from ``pending`` (mutated in
        place), in the order the coalescer should pack them."""
        for t in pending:
            if t not in self._deficit:
                self._deficit[t] = 0.0
                self._ring.append(t)
        taken: List[T] = []
        if n_slots <= 0 or not self._ring:
            return taken
        # rounds terminate: every backlogged tenant gains quantum*weight
        # (> 0) deficit per round, so some queue drains every
        # ceil(1/(quantum*min_weight)) rounds at the latest
        while len(taken) < n_slots and \
                any(pending.get(t) for t in self._ring):
            n = len(self._ring)
            start = self._cursor % n
            for i in range(n):
                idx = (start + i) % n
                t = self._ring[idx]
                q = pending.get(t)
                if not q:
                    self._deficit[t] = 0.0  # no banked credit while idle
                    continue
                self._deficit[t] += self.quantum * self.weight(t)
                while q and self._deficit[t] >= 1.0:
                    if len(taken) >= n_slots:
                        # batch boundary mid-service: resume HERE next
                        # select, with the unspent deficit kept
                        self._cursor = idx
                        return taken
                    taken.append(q.popleft())
                    self._deficit[t] -= 1.0
                if not q:
                    self._deficit[t] = 0.0
        return taken
