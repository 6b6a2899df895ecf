"""AcyclicAddEdge — batched, with the paper's relaxed (false-positive) spec.

Port of `repro.core.acyclic`.  All candidate edges of a (sub-)batch are
inserted in transit, the cycle check runs over ``G ∪ transit``, and every
candidate lying on a cycle is rejected (joint aborts, which the paper
allows).  ``method`` picks the check — "closure" (Algorithm 1),
"partial" (Algorithm 2), "incremental" (the closure cache) or "auto"
(the dispatch policy) — and all four decide identically; only the work
differs.  ``subbatches=K`` checks K priority classes in sequence.

The reference's ``lax.scan`` over sub-batches is a host loop, and its
``lax.cond`` / ``lax.switch`` are host branches.  On the tiled closure
layout the incremental check reads the region window; a dirty cache
whose graph has spilled past the window is decided by the exact
from-scratch partial check instead (the tiles stay stale).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import bitset, closure_cache, dispatch, snapshot
from repro_torch.core.closure_cache import ClosureCache
from repro_torch.core.dag import DagState, _valid, lookup_slots
from repro_torch.core.reachability import MatmulImpl, transitive_closure

METHODS = dispatch.METHODS

# branch codes in the per-sub-batch stats (what the dispatcher chose)
CHOSE_CLOSURE, CHOSE_PARTIAL, CHOSE_INCREMENTAL = 0, 1, 2

# prefer_partial_fn signature: (transit adjacency int32[C, W], sub-batch
# size) -> bool-like.  `core/engine.py` closes a DispatchPolicy (plus its
# measured-depth EMA) over this hook.
PreferPartialFn = Callable[[torch.Tensor, int], object]


def acyclic_add_edges_impl(
        state: DagState, us: torch.Tensor, vs: torch.Tensor,
        valid=None, subbatches: int = 1,
        matmul_impl: Optional[MatmulImpl] = None,
        method: str = "closure", with_stats: bool = False,
        prefer_partial_fn: Optional[PreferPartialFn] = None,
        partial_matmul_impl: Optional[MatmulImpl] = None,
        cache: Optional[ClosureCache] = None,
        closure_update_impl=None, n_shards: int = 1,
        prefer_incremental_fn=None):
    """Returns (state, ok[B]) — or, with a closure cache in play (``cache``
    passed, or ``method="incremental"``), (state, ok[B], cache'); either
    form appends ``stats`` under ``with_stats``.

    ok: False if an endpoint is not live; True if the edge exists; True if
    inserted without a cycle; False if it lies on a cycle of
    ``G ∪ transit``.  stats = {"n_products", "rows_per_product",
    "row_products", "n_partial", "n_incremental", "n_repair",
    "deciding_depth"} as in the reference; the counts are ints and
    ``deciding_depth`` an int32[n_shards] CPU tensor (the per-shard
    deciding hops of the last algorithm-2 check, zeros if none ran)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    valid = _valid(valid, us)
    b = us.shape[0]
    if b % subbatches != 0:
        raise ValueError(f"batch {b} not divisible by subbatches {subbatches}")
    b_sub = b // subbatches
    capacity = state.capacity
    rows_per_product = {"closure": capacity, "partial": b_sub,
                        "auto": -1, "incremental": capacity}[method]
    p_impl = partial_matmul_impl if partial_matmul_impl is not None \
        else matmul_impl
    prefer = prefer_partial_fn if prefer_partial_fn is not None \
        else dispatch.prefer_partial_from_adj
    prefer_inc = prefer_incremental_fn if prefer_incremental_fn is not None \
        else (lambda dirty: not dirty)
    cached = cache is not None or method == "incremental"
    if cached and cache is None:
        # standalone incremental call: conservative dirty cache -> the
        # first sub-batch pays one lazy rebuild, the rest ride the cache
        cache = closure_cache.empty_cache(capacity, dirty=True,
                                          device=state.device)
    tiled = cached and closure_cache.is_tiled(cache.closure)
    region = cache.closure.region if tiled else capacity
    zero_depths = torch.zeros((n_shards,), dtype=torch.int32)

    def shard_depths(decided_at: torch.Tensor) -> torch.Tensor:
        """Per-row deciding hops -> per-shard maxima (contiguous blocks);
        non-divisible batches broadcast the global max to every shard."""
        d = decided_at.cpu()
        if n_shards > 1 and b_sub % n_shards == 0:
            return torch.amax(d.reshape(n_shards, -1), dim=1)
        return torch.max(d).expand(n_shards).clone()

    adj = state.adj
    closure = cache.closure if cached else None
    dirty = cache.dirty if cached else True
    oks = []
    n_products = row_products = n_partial = n_incremental = 0
    deciding_depth = zero_depths
    for k in range(subbatches):
        sl = slice(k * b_sub, (k + 1) * b_sub)
        u, v, val = us[sl], vs[sl], valid[sl]
        u_slot, u_found = lookup_slots(state, u)
        v_slot, v_found = lookup_slots(state, v)
        vert_ok = val & u_found & v_found
        self_loop = vert_ok & (u == v)
        already = vert_ok & bitset.bit_get(adj, u_slot, v_slot)
        cand = vert_ok & ~already & ~self_loop
        adj_t = bitset.scatter_set_bits(adj, u_slot, v_slot, cand)  # transit

        if method == "auto":
            if cached and prefer_inc(dirty):
                chose = CHOSE_INCREMENTAL
            elif bool(prefer(adj_t, b_sub)):
                chose = CHOSE_PARTIAL
            else:
                chose = CHOSE_CLOSURE
        else:
            chose = {"closure": CHOSE_CLOSURE, "partial": CHOSE_PARTIAL,
                     "incremental": CHOSE_INCREMENTAL}[method]

        if chose == CHOSE_CLOSURE:
            cfull, n = transitive_closure(adj_t, matmul_impl, with_stats=True)
            cyc = bitset.bit_get(cfull, v_slot, u_slot)  # path v -> u
            rp = n * capacity
            if cached:
                any_reject = bool(torch.any(cand & cyc))
                any_accept = bool(torch.any(cand & ~cyc))
                # opportunistic refresh: with zero rejects the committed
                # graph IS G ∪ transit, so cfull is its exact closure
                if tiled:
                    # adopted into the window only when the transit graph
                    # fits it (a confined graph has a confined closure)
                    if not any_reject and closure_cache.region_confined(
                            adj_t, region):
                        closure = closure_cache.tiled_of(cfull, region)
                        dirty = False
                    else:
                        dirty = dirty or any_accept
                elif any_reject:
                    dirty = dirty or any_accept
                else:
                    closure, dirty = cfull, False
        elif chose == CHOSE_PARTIAL:
            cyc, n, decided_at = snapshot.partial_cycle_check(
                adj_t, u_slot, v_slot, cand, p_impl, with_stats=True,
                with_depths=True)
            rp = n * b_sub
            if cached:  # accepts stale the cache
                dirty = dirty or bool(torch.any(cand & ~cyc))
            n_partial += 1
            deciding_depth = shard_depths(decided_at)
        else:
            # lazy rebuild on a dirty cache (charged as closure products),
            # then the B^2-bit-read check and the rank-B fold-in
            closure0, n = closure_cache.refresh_closure(closure, dirty, adj,
                                                        matmul_impl)
            if not tiled:
                cyc = closure_cache.incremental_cycle_check(closure0, u_slot,
                                                            v_slot, cand)
                closure = closure_cache.insert_update(
                    closure0, u_slot, v_slot, cand & ~cyc,
                    closure_update_impl)
                dirty = False
                rp = n * capacity
            elif dirty and not closure_cache.region_confined(adj, region):
                # the committed graph has spilled past the window (only
                # when the window is not widened host-side): the tiles stay
                # stale and the exact from-scratch partial check decides
                cyc, n, _ = snapshot.partial_cycle_check(
                    adj_t, u_slot, v_slot, cand, p_impl, with_stats=True,
                    with_depths=True)
                closure, dirty, rp = closure0, True, n * b_sub
            else:
                cyc = closure_cache.incremental_cycle_check(closure0, u_slot,
                                                            v_slot, cand)
                closure, dirty = closure_cache.insert_update_tiled(
                    closure0, u_slot, v_slot, cand & ~cyc,
                    closure_update_impl)
                rp = n * region
            n_incremental += 1
        n_products += n
        row_products += rp
        reject = cand & cyc
        adj = bitset.scatter_clear_bits(adj_t, u_slot, v_slot, reject)
        oks.append(already | (cand & ~cyc))

    state = state._replace(adj=adj)
    ok = torch.cat(oks)
    # the insert scan never runs a delete repair: the repair-depth EMA
    # rides through unchanged
    out_cache = ClosureCache(closure, dirty, cache.repair_ema) \
        if cached else None
    if not with_stats:
        return (state, ok, out_cache) if cached else (state, ok)
    stats = {"n_products": n_products, "rows_per_product": rows_per_product,
             "row_products": row_products, "n_partial": n_partial,
             "n_incremental": n_incremental,
             "n_repair": 0,  # insert checks never delete-repair
             "deciding_depth": deciding_depth}
    if cached:
        return state, ok, out_cache, stats
    return state, ok, stats
