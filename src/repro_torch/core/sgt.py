"""Serialization Graph Testing (SGT) scheduler — the paper's motivating
app, in torch.

Port of `repro.core.sgt`.  The conflict graph of live transactions is an
acyclic concurrent DAG held in a `core/engine.DagEngine` session.  One
batch == one scheduling tick:

  begin(txn_ids)            -> AddVertex batch
  conflicts((t_i, t_j))     -> AcyclicAddEdge batch; a rejected edge means
                               the *requesting* transaction t_i aborts
  retire_conflicts((i, j))  -> RemoveEdge batch
  finish(txn_ids)           -> RemoveVertex batch (commit or abort retire)

Aborted transactions are retired inside the tick.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import dag
from repro_torch.core.engine import DagEngine


class SgtState(NamedTuple):
    engine: DagEngine
    n_begun: torch.Tensor      # int32
    n_committed: torch.Tensor  # int32
    n_aborted: torch.Tensor    # int32

    @property
    def graph(self) -> dag.DagState:
        """The conflict graph's raw slab (read-only)."""
        return self.engine.state


def _count(ok: torch.Tensor) -> torch.Tensor:
    return torch.sum(ok, dtype=torch.int32)


def new_scheduler(capacity: int, *, backend: str = "local",
                  method: str = "auto", subbatches: int = 1,
                  matmul_impl=None, policy=None, mesh=None,
                  auto_grow: bool = False, device=None) -> SgtState:
    """Scheduler over a fresh engine session; the keyword options mirror
    `DagEngine.create` (``device=None`` is the card)."""
    eng = DagEngine.create(capacity, backend=backend, method=method,
                           subbatches=subbatches, matmul_impl=matmul_impl,
                           policy=policy, mesh=mesh, auto_grow=auto_grow,
                           device=device)
    z = torch.zeros((), dtype=torch.int32, device=eng.device)
    return SgtState(eng, z, z, z)


def grow(state: SgtState, new_capacity: int) -> SgtState:
    """Re-embed the scheduler's conflict graph at a larger capacity."""
    return state._replace(engine=state.engine.grow(new_capacity))


def maybe_grow(state: SgtState, overflow_handled: int = 0,
               factor: int = 2):
    """Between-ticks backpressure hook: if the engine dropped begins for
    capacity since ``overflow_handled`` drops were accounted, grow by
    ``factor``.  Returns ``(state', overflow_handled')``."""
    seen = int(state.engine.state.n_overflow)
    if seen > overflow_handled:
        state = grow(state, state.engine.capacity * factor)
    return state, seen


def begin(state: SgtState, txn_ids, valid=None):
    eng, r = state.engine.add_vertices(txn_ids, valid=valid)
    return state._replace(engine=eng,
                          n_begun=state.n_begun + _count(r.ok)), r.ok


def conflicts(state: SgtState, src, dst, valid=None,
              subbatches: Optional[int] = None, matmul_impl=None,
              method: Optional[str] = None):
    """Register conflict edges src -> dst. Returns (state, accepted[B]).

    accepted=False with live endpoints means a cycle was (possibly
    jointly) detected: the source transaction is aborted and retired.
    ``method`` / ``subbatches`` / ``matmul_impl`` are per-call overrides
    of the engine configuration (None inherits it)."""
    eng = state.engine
    src, dst = eng._keys(src), eng._keys(dst)
    if method is not None or subbatches is not None or \
            matmul_impl is not None:
        eng = eng.with_options(
            method=method, subbatches=subbatches,
            **({} if matmul_impl is None
               else {"matmul_impl": matmul_impl}))
    eng, r = eng.add_edges_acyclic(src, dst, valid=valid)
    ok = r.ok
    live = eng.contains(src) & eng.contains(dst)
    if valid is not None:
        live = live & valid
    aborted = live & ~ok
    # retire aborted transactions (vertex + incident edges); the remove-ok
    # count deduplicates a txn appearing in several conflicts of one batch
    eng, rem = eng.remove_vertices(src, valid=aborted)
    # carry the session forward under the scheduler's ORIGINAL config
    eng = DagEngine.wrap(eng.state, state.engine.config,
                         depth_ema=eng.depth_ema, cache=eng.cache,
                         epoch=eng.epoch)
    return state._replace(engine=eng,
                          n_aborted=state.n_aborted + _count(rem.ok)), ok


def retire_conflicts(state: SgtState, src, dst, valid=None):
    """Drop conflict edges src -> dst. Returns (state, ok[B])."""
    eng, r = state.engine.remove_edges(src, dst, valid=valid)
    return state._replace(engine=eng), r.ok


def finish(state: SgtState, txn_ids, valid=None):
    eng, r = state.engine.remove_vertices(txn_ids, valid=valid)
    return state._replace(engine=eng,
                          n_committed=state.n_committed + _count(r.ok)), r.ok


def schedule_tick(state: SgtState, begin_ids, conf_src, conf_dst, finish_ids,
                  subbatches: Optional[int] = None,
                  method: Optional[str] = None):
    """One bulk-synchronous scheduling tick: begins, conflicts, finishes."""
    state, began = begin(state, begin_ids)
    state, accepted = conflicts(state, conf_src, conf_dst,
                                subbatches=subbatches, method=method)
    state, finished = finish(state, finish_ids)
    return state, {"began": began, "accepted": accepted, "finished": finished}


def churn_tick(state: SgtState, begin_ids, conf_src, conf_dst, drop_src,
               drop_dst, finish_ids, subbatches: Optional[int] = None,
               method: Optional[str] = None):
    """One delete-heavy scheduling tick: begins, conflicts, conflict-edge
    retirements, finishes."""
    state, began = begin(state, begin_ids)
    state, accepted = conflicts(state, conf_src, conf_dst,
                                subbatches=subbatches, method=method)
    state, dropped = retire_conflicts(state, drop_src, drop_dst)
    state, finished = finish(state, finish_ids)
    return state, {"began": began, "accepted": accepted, "dropped": dropped,
                   "finished": finished}
