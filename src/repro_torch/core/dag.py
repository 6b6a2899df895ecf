"""Batched non-blocking concurrent DAG — the paper's object, in torch.

Port of `repro.core.dag`.  A batch of operation requests (one per logical
"thread") is applied in one data-parallel step, with a deterministic
linearization (phase order, then batch-index order) that the tests hold
against the sequential oracle (`core/oracle.py`).

State layout (capacity-bounded slab, slots recycled via a free list):
  keys  : int32[C]    key stored in each slot (EMPTY_KEY when free)
  alive : bool[C]     slot liveness (logical deletion == clearing this)
  adj   : int32[C,W]  bit-packed adjacency rows (uint32 bit pattern)

Every function is out of place: a state once returned is never written.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitset

EMPTY_KEY = -1

# op codes for mixed workloads (phase order == linearization order)
REMOVE_VERTEX = 0
ADD_VERTEX = 1
REMOVE_EDGE = 2
ADD_EDGE = 3
CONTAINS_VERTEX = 4
CONTAINS_EDGE = 5


class DagState(NamedTuple):
    keys: torch.Tensor        # int32[C]
    alive: torch.Tensor       # bool[C]
    adj: torch.Tensor         # int32[C, W]
    n_overflow: torch.Tensor  # int32 scalar: vertex adds dropped for capacity

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def new_state(capacity: int, device="cpu") -> DagState:
    w = bitset.n_words(capacity)
    return DagState(
        keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32,
                        device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        adj=torch.zeros((capacity, w), dtype=torch.int32, device=device),
        n_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def grow_state(state: DagState, new_capacity: int) -> DagState:
    """Re-embed the slab at a larger capacity.  Slots keep their indices,
    so growth is pure zero-padding (see `repro.core.dag.grow_state`)."""
    c = state.capacity
    if new_capacity == c:
        return state
    if new_capacity < c:
        raise ValueError(
            f"cannot shrink: new capacity {new_capacity} < current {c}")
    w = state.adj.shape[1]
    w_new = bitset.n_words(new_capacity)
    dev = state.device
    return DagState(
        keys=torch.cat([state.keys, torch.full(
            (new_capacity - c,), EMPTY_KEY, dtype=torch.int32, device=dev)]),
        alive=torch.cat([state.alive, torch.zeros(
            (new_capacity - c,), dtype=torch.bool, device=dev)]),
        adj=torch.nn.functional.pad(state.adj,
                                    (0, w_new - w, 0, new_capacity - c)),
        n_overflow=state.n_overflow,
    )


def lookup_slots(state: DagState, keys: torch.Tensor):
    """keys int32[B] -> (slot int32[B], found bool[B]).  ``argmax`` returns
    the first maximal index, which is the lowest matching slot."""
    m = state.alive[None, :] & (state.keys[None, :] == keys[:, None])
    found = m.any(dim=1)
    slot = torch.argmax(m.to(torch.uint8), dim=1).to(torch.int32)
    return slot, found


def _valid(valid, like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(like.shape[0], dtype=torch.bool, device=like.device)
    return valid


def _batch_iota(keys: torch.Tensor) -> torch.Tensor:
    return torch.arange(keys.shape[0], dtype=keys.dtype, device=keys.device)


# ---------------------------------------------------------------- vertices

def add_vertices(state: DagState, keys: torch.Tensor, valid=None):
    """AddVertex batch. Returns (state, ok[B]).

    Re-adding a live key is a no-op returning true.  Capacity overflow
    yields ok=False and bumps ``n_overflow`` (host controller contract)."""
    valid = _valid(valid, keys)
    c = state.capacity
    dev = state.device
    _, exists = lookup_slots(state, keys)
    first = bitset._first_occurrence(
        torch.where(valid & ~exists, keys, -_batch_iota(keys) - 2))
    need = valid & ~exists & first
    free = ~state.alive
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_for_rank = torch.zeros((c,), dtype=torch.int32, device=dev)
    slot_for_rank[free_rank[free].long()] = torch.arange(
        c, dtype=torch.int32, device=dev)[free]
    n_free = torch.sum(free.to(torch.int32))
    need_rank = torch.cumsum(need.to(torch.int32), 0) - 1
    overflow = need & (need_rank >= n_free)
    place = need & ~overflow
    tgt = slot_for_rank[torch.where(place, need_rank, 0).long()]
    keys_new = state.keys.clone()
    alive_new = state.alive.clone()
    keys_new[tgt[place].long()] = keys[place]
    alive_new[tgt[place].long()] = True
    state = state._replace(
        keys=keys_new, alive=alive_new,
        n_overflow=state.n_overflow + torch.sum(overflow, dtype=torch.int32))
    # ok == "key is live in the post-state" (pre-existing keys, placements
    # and in-batch duplicates; overflowed keys report False)
    _, exists_after = lookup_slots(state, keys)
    return state, valid & exists_after


def remove_vertices(state: DagState, keys: torch.Tensor, valid=None):
    """RemoveVertex batch: logical+physical removal, plus the paper's
    RemoveIncomingEdges as a single masked column clear. Returns (state, ok)."""
    state, rem, _ = remove_vertices_delta(state, keys, valid=valid)
    return state, rem


def remove_vertices_delta(state: DagState, keys: torch.Tensor, valid=None):
    """`remove_vertices` that also emits the adjacency-diff-exact
    `CacheDelta` (only removals whose slot had an incident edge seed a
    cache repair).  Returns (state, ok, delta)."""
    from repro_torch.core.closure_cache import CacheDelta

    valid = _valid(valid, keys)
    c = state.capacity
    slot, found = lookup_slots(state, keys)
    first = bitset._first_occurrence(
        torch.where(valid & found, keys, -_batch_iota(keys) - 2))
    rem = valid & found & first
    # adjacency-touching test on the PRE-removal slab (slot is garbage for
    # non-removed rows — masked out by ``rem``)
    out_any = torch.any(state.adj[torch.where(rem, slot, 0).long()] != 0,
                        dim=-1)
    word = (slot >> 5).long()
    shift = slot & 31
    col_bits = (state.adj[:, word] >> shift[None, :]) & 1
    in_any = torch.any(col_bits != 0, dim=0)
    touched = rem & (out_any | in_any)
    gone = slot[rem].long()
    alive_new = state.alive.clone()
    keys_new = state.keys.clone()
    alive_new[gone] = False
    keys_new[gone] = EMPTY_KEY
    removed_row = torch.zeros((c,), dtype=torch.bool, device=state.device)
    removed_row[gone] = True
    colmask = bitset.pack_bits(removed_row)  # (W,)
    adj_new = torch.where(removed_row[:, None], 0, state.adj)
    adj_new = adj_new & ~colmask[None, :]
    state = state._replace(keys=keys_new, alive=alive_new, adj=adj_new)
    return state, rem, CacheDelta.vertices_cleared(slot, touched)


# ------------------------------------------------------------------- edges

def add_edges(state: DagState, us: torch.Tensor, vs: torch.Tensor,
              valid=None):
    """Plain AddEdge batch (no acyclicity): ok iff both endpoints live."""
    valid = _valid(valid, us)
    u_slot, u_found = lookup_slots(state, us)
    v_slot, v_found = lookup_slots(state, vs)
    ok = valid & u_found & v_found
    adj = bitset.scatter_set_bits(state.adj, u_slot, v_slot, ok)
    return state._replace(adj=adj), ok


def remove_edges(state: DagState, us: torch.Tensor, vs: torch.Tensor,
                 valid=None):
    state, ok, _ = remove_edges_delta(state, us, vs, valid=valid)
    return state, ok


def remove_edges_delta(state: DagState, us: torch.Tensor, vs: torch.Tensor,
                       valid=None):
    """`remove_edges` that also emits the adjacency-diff-exact `CacheDelta`
    (only removals whose bit was really set, first occurrence of a
    duplicated pair, seed a repair).  ``ok`` keeps the sequential spec.
    Returns (state, ok, delta)."""
    from repro_torch.core.closure_cache import CacheDelta

    valid = _valid(valid, us)
    u_slot, u_found = lookup_slots(state, us)
    v_slot, v_found = lookup_slots(state, vs)
    ok = valid & u_found & v_found
    existed = bitset.bit_get(state.adj, u_slot, v_slot)
    first = bitset._dedupe_enabled(u_slot, v_slot, ok & existed,
                                   state.capacity)
    cleared = ok & existed & first
    adj = bitset.scatter_clear_bits(state.adj, u_slot, v_slot, ok)
    return (state._replace(adj=adj), ok,
            CacheDelta.edges_removed(u_slot, v_slot, cleared))


# ---------------------------------------------------- wait-free reads

def contains_vertices(state: DagState, keys: torch.Tensor) -> torch.Tensor:
    _, found = lookup_slots(state, keys)
    return found


def contains_edges(state: DagState, us: torch.Tensor,
                   vs: torch.Tensor) -> torch.Tensor:
    u_slot, u_found = lookup_slots(state, us)
    v_slot, v_found = lookup_slots(state, vs)
    return u_found & v_found & bitset.bit_get(state.adj, u_slot, v_slot)


# ------------------------------------------------- mixed-op workloads

def apply_op_batch_impl(state: DagState, op: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, acyclic: bool = False,
                        subbatches: int = 1, method: str = "closure",
                        matmul_impl=None, with_stats: bool = False,
                        prefer_partial_fn=None, partial_matmul_impl=None,
                        cache=None, closure_update_impl=None,
                        n_shards: int = 1, prefer_incremental_fn=None,
                        closure_delete_impl=None, prefer_repair_fn=None):
    """Apply a mixed batch with the documented linearization:
    RemoveVertex -> AddVertex -> RemoveEdge -> AddEdge -> reads.

    Same contract as `repro.core.dag.apply_op_batch_impl`: with ``cache``
    the two delete phases' `CacheDelta`s merge into ONE
    `closure_cache.commit` against the post-removal adjacency, before
    AddEdge.  Returns (state, ok[, cache][, stats])."""
    from repro_torch.core import acyclic as acyclic_mod
    from repro_torch.core import closure_cache as cc_mod

    res = torch.zeros(op.shape[0], dtype=torch.bool, device=op.device)
    # acyclic_add_edges_impl threads (and returns) a cache for
    # method="incremental" even when none was passed
    cached = cache is not None or (acyclic and method == "incremental")
    commit_products = commit_rows = commit_repairs = 0

    if cache is not None:
        state, r, d_v = remove_vertices_delta(state, a,
                                              valid=op == REMOVE_VERTEX)
    else:
        state, r = remove_vertices(state, a, valid=op == REMOVE_VERTEX)
    res = torch.where(op == REMOVE_VERTEX, r, res)
    state, r = add_vertices(state, a, valid=op == ADD_VERTEX)
    res = torch.where(op == ADD_VERTEX, r, res)
    if cache is not None:
        state, r, d_e = remove_edges_delta(state, a, b,
                                           valid=op == REMOVE_EDGE)
        # one coalesced commit for the whole tick's delete work
        cache, st = cc_mod.commit(
            cache, cc_mod.CacheDelta.merge(d_v, d_e), state.adj,
            update_impl=closure_update_impl, delete_impl=closure_delete_impl,
            prefer_repair_fn=prefer_repair_fn, with_stats=True)
        commit_products += st["n_products"]
        commit_rows += st["row_products"]
        commit_repairs += st["n_repair"]
    else:
        state, r = remove_edges(state, a, b, valid=op == REMOVE_EDGE)
    res = torch.where(op == REMOVE_EDGE, r, res)
    stats = {"n_products": 0, "rows_per_product": 0, "row_products": 0,
             "n_partial": 0, "n_incremental": 0, "n_repair": 0,
             "deciding_depth": torch.zeros((n_shards,), dtype=torch.int32)}
    if acyclic:
        out = acyclic_mod.acyclic_add_edges_impl(
            state, a, b, valid=op == ADD_EDGE, subbatches=subbatches,
            method=method, matmul_impl=matmul_impl, with_stats=with_stats,
            prefer_partial_fn=prefer_partial_fn,
            partial_matmul_impl=partial_matmul_impl, cache=cache,
            closure_update_impl=closure_update_impl, n_shards=n_shards,
            prefer_incremental_fn=prefer_incremental_fn)
        if cached and with_stats:
            state, r, cache, stats = out
        elif cached:
            state, r, cache = out
        elif with_stats:
            state, r, stats = out
        else:
            state, r = out
    else:
        adj_pre = state.adj
        state, r = add_edges(state, a, b, valid=op == ADD_EDGE)
        if cache is not None:
            # unconstrained inserts bypass the cycle check (and the rank-B
            # fold-in): the cache goes stale
            cache = cache.invalidated_if(bool(torch.any(state.adj != adj_pre)))
    if with_stats and cache is not None:
        stats = dict(stats)
        stats["n_products"] += commit_products
        stats["row_products"] += commit_rows
        stats["n_repair"] += commit_repairs
    res = torch.where(op == ADD_EDGE, r, res)
    r = contains_vertices(state, a)
    res = torch.where(op == CONTAINS_VERTEX, r, res)
    r = contains_edges(state, a, b)
    res = torch.where(op == CONTAINS_EDGE, r, res)
    if cached and with_stats:
        return state, res, cache, stats
    if cached:
        return state, res, cache
    if with_stats:
        return state, res, stats
    return state, res


def apply_op_sequential(state: DagState, op: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, acyclic: bool = False,
                        method: str = "closure"):
    """Coarse-grained baseline: one op at a time (the moral equivalent of
    the paper's single global lock).  ``method="incremental"`` threads one
    closure cache through the whole chain."""
    res = torch.zeros(op.shape[0], dtype=torch.bool, device=op.device)
    cache = None
    if acyclic and method == "incremental":
        from repro_torch.core import closure_cache
        cache = closure_cache.empty_cache(state.capacity, dirty=True,
                                          device=state.device)
    for i in range(op.shape[0]):
        sl = slice(i, i + 1)
        if cache is not None:
            state, r, cache = apply_op_batch_impl(
                state, op[sl], a[sl], b[sl], acyclic=True, subbatches=1,
                method=method, cache=cache)
        else:
            state, r = apply_op_batch_impl(state, op[sl], a[sl], b[sl],
                                           acyclic=acyclic, subbatches=1,
                                           method=method)
        res[i] = r[0]
    return state, res


# ------------------------------------------------------------- invariants

def live_vertex_count(state: DagState) -> torch.Tensor:
    return torch.sum(state.alive, dtype=torch.int32)


def edge_count(state: DagState) -> torch.Tensor:
    return torch.sum(bitset.popcount(state.adj), dtype=torch.int32)
