"""Incremental transitive-closure cache — `method="incremental"`, in torch.

Port of `repro.core.closure_cache`, both layouts.  The packed strict
closure of the committed graph is carried as session state, either as the
dense slab int32[C, C/32] or as a `TiledClosure` (32x32-bit tiles confined
to a leading region window, plus a per-tile occupancy summary); every
operation dispatches on the layout, so the two share one commit protocol:

  * **Check** — against a clean cache, candidate edge (u, v) closes a
    cycle iff the strict closure of the B x B candidate hop graph
    ``A[i, j] = reach(v_i, u_j)`` has bit (i, i): B^2 bit reads plus a
    B x B closure, zero C-row products.
  * **Commit** — every mutation reaches the cache as a typed `CacheDelta`
    through the single `commit` entry point: removals repair the affected
    rows (ancestors of each removal seed) with the bounded masked scan
    `masked_delete_scan` (kernel B3 per hop on the card), or invalidate
    when the policy's delete arm says repair would not pay; accepted adds
    fold in with one rank-B update (kernel B2 on the card).
  * **Tiled layout** — the same operations on the region window: the fold
    is kernel B4 and the repair hop kernel B5, each of which also emits
    the output's per-tile occupancy, packed into the summary with
    `summary_from_occ`.  An edge or removal past the window cannot be
    represented in the tiles: the commit degrades the cache to dirty
    (never to wrong bits), and the engine widens the window host-side.

The reference's ``lax.cond`` / ``while_loop`` / ``fori_loop`` are host
branches and loops; the branch choices, the product counts and the
float32 ``repair_ema`` equal the reference's.  ``dirty`` is a Python bool
and ``repair_ema`` a float32 CPU scalar tensor (host bookkeeping, so the
card and the CPU compute it identically); the closure lives on the
engine's device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bitset
from repro_torch.core.reachability import (MatmulImpl, closure_iteration_bound,
                                           transitive_closure)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import tile_occupancy_ref

# update_impl signature: (closure (C, W), mask (C, B/32), rows (B, W)) ->
# new closure (C, W).  Default: `kernels/ops.closure_update` (kernel B2
# on CUDA tensors, the plain version on CPU tensors).
ClosureUpdateImpl = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                             torch.Tensor]

# delete_impl signature: (adj_after (C, W), closure (C, W), affected
# bool[C]) -> (closure' (C, W), n_products int, row_products int).
DeleteScanImpl = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple]

class ClosureCache(NamedTuple):
    """The packed strict transitive closure of the committed graph, plus a
    staleness flag and the measured repair-depth EMA.  ``dirty=True``
    means ``closure`` may be stale and must be rebuilt before use."""

    closure: object           # int32[C, W] dense, or a TiledClosure
    dirty: bool               # True -> rebuild before use
    repair_ema: torch.Tensor  # float32[] on the CPU: EMA of measured
    #                           delete-repair scan depths (0 = unseeded)

    @property
    def capacity(self) -> int:
        return closure_capacity(self.closure)

    def invalidated_if(self, changed: bool) -> "ClosureCache":
        """Mark dirty when ``changed`` — the fallback for mutations that
        bypass the delta-commit pipeline."""
        return self._replace(dirty=self.dirty or bool(changed))


def _ema0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32)


def empty_cache(capacity: int, dirty: bool = False,
                device="cpu") -> ClosureCache:
    """Cache for an empty graph (its strict closure IS all-zeros, so
    ``dirty=False`` is exact for a fresh engine)."""
    w = bitset.n_words(capacity)
    return ClosureCache(torch.zeros((capacity, w), dtype=torch.int32,
                                    device=device), bool(dirty), _ema0())


# -------------------------------------------------- tiled representation

TILE = bitset.WORD  # 32x32-bit tiles: one word per tile row

DEFAULT_REGION = 1024  # fresh tiled caches open a 1024-slot window


class TiledClosure(NamedTuple):
    """Block-sparse packed closure: 32x32-bit tiles confined to a leading
    ``region x region`` window, plus a per-tile occupancy summary bitmap
    over the full capacity's tile grid.

    ``tiles`` equals the leading ``[:region, :region//32]`` window of the
    dense packed closure; every closure bit outside the window is zero
    (the confinement invariant).  ``summary`` packs one bit per 32x32
    tile: bit (I, J) is set iff the tile at rows 32I..32I+31, word column
    J is non-empty."""

    tiles: torch.Tensor    # int32[R, R/32]: closure bits of the window
    summary: torch.Tensor  # int32[C/32, ceil(C/1024)]: per-tile occupancy

    @property
    def capacity(self) -> int:
        return self.summary.shape[0] * TILE

    @property
    def region(self) -> int:
        return self.tiles.shape[0]


def is_tiled(closure) -> bool:
    return isinstance(closure, TiledClosure)


def closure_capacity(closure) -> int:
    return closure.capacity if is_tiled(closure) else closure.shape[0]


def closure_nbytes(closure) -> int:
    """Resident closure bytes: tiles plus summary on the tiled layout, the
    slab on the dense one."""
    leaves = closure if is_tiled(closure) else (closure,)
    return sum(x.numel() * x.element_size() for x in leaves)


def summary_words(capacity: int) -> int:
    """Packed words per summary row (the tile grid is C/32 wide; rows pad
    up to a whole word so capacities below 1024 still pack)."""
    return (capacity // TILE + TILE - 1) // TILE


def align_region(n: int, capacity: int) -> int:
    """Smallest valid window >= n: a multiple of 32, capped at capacity."""
    r = max(TILE, ((int(n) + TILE - 1) // TILE) * TILE)
    return min(r, capacity)


def default_region(capacity: int) -> int:
    return align_region(min(capacity, DEFAULT_REGION), capacity)


def summary_from_occ(occ: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pack a per-tile occupancy plane (0/1, region grid — what kernels B4
    and B5 emit) into the capacity's summary bitmap."""
    t, sw = capacity // TILE, summary_words(capacity)
    tr, tc = occ.shape
    full = torch.zeros((t, sw * TILE), dtype=torch.bool, device=occ.device)
    full[:tr, :tc] = occ != 0
    return bitset.pack_bits(full)


def build_summary(tiles: torch.Tensor, capacity: int) -> torch.Tensor:
    """The summary of ``tiles`` read off the tiles themselves (one pass);
    tiles beyond the window are empty under confinement."""
    return summary_from_occ(tile_occupancy_ref(tiles), capacity)


def occupied_tiles(closure: TiledClosure) -> torch.Tensor:
    """int32: the number of non-empty tiles."""
    return torch.sum(bitset.popcount(closure.summary))


def empty_tiled_cache(capacity: int, region: int = 0, dirty: bool = False,
                      device="cpu") -> ClosureCache:
    """Tiled-layout cache for an empty graph (see `empty_cache`)."""
    r = align_region(region or default_region(capacity), capacity)
    tiles = torch.zeros((r, r // TILE), dtype=torch.int32, device=device)
    return ClosureCache(TiledClosure(tiles, build_summary(tiles, capacity)),
                        bool(dirty), _ema0())


def region_window(packed: torch.Tensor, region: int) -> torch.Tensor:
    """The leading ``region x region`` window of a (C, C/32) bit matrix, as
    a contiguous tensor (the kernels take no row stride)."""
    return packed[:region, : region // TILE].contiguous()


def region_confined(adj_packed: torch.Tensor, region: int) -> bool:
    """No adjacency bit lies outside the leading region window — the
    precondition for representing the closure in tiles alone."""
    wr = region // TILE
    return not (bool(torch.any(adj_packed[region:, :]))
                or bool(torch.any(adj_packed[:region, wr:])))


def dense_of(closure) -> torch.Tensor:
    """The dense int32[C, C/32] equivalent (zero outside the window)."""
    if not is_tiled(closure):
        return closure
    c = closure.capacity
    r, wr = closure.tiles.shape
    return torch.nn.functional.pad(closure.tiles,
                                   (0, bitset.n_words(c) - wr, 0, c - r))


def tiled_of(closure: torch.Tensor, region: int) -> TiledClosure:
    """Re-represent a dense packed closure as tiles; ``region`` must
    already cover every set bit (callers check confinement)."""
    c = closure.shape[0]
    tiles = region_window(closure, align_region(region, c))
    return TiledClosure(tiles, build_summary(tiles, c))


def grow_closure(closure, new_capacity: int):
    """Zero-pad a closure to a larger capacity: the dense slab pads; a
    tiled closure pads only its summary (the tiles window is untouched)."""
    if is_tiled(closure):
        if new_capacity == closure.capacity:
            return closure
        t, sw = new_capacity // TILE, summary_words(new_capacity)
        rows, words = closure.summary.shape
        return TiledClosure(closure.tiles, torch.nn.functional.pad(
            closure.summary, (0, sw - words, 0, t - rows)))
    c, w = closure.shape
    if new_capacity == c:
        return closure
    return torch.nn.functional.pad(
        closure, (0, bitset.n_words(new_capacity) - w, 0, new_capacity - c))


def grow_region(closure: TiledClosure, new_region: int) -> TiledClosure:
    """Widen the tiles window (summary unchanged: the new tiles are
    empty)."""
    r, wr = closure.tiles.shape
    nr = align_region(new_region, closure.capacity)
    if nr <= r:
        return closure
    tiles = torch.nn.functional.pad(closure.tiles,
                                    (0, nr // TILE - wr, 0, nr - r))
    return TiledClosure(tiles, closure.summary)


def closure_bit_get(closure, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Layout-polymorphic `bitset.bit_get`: out-of-window reads are False,
    which is exact under confinement."""
    if not is_tiled(closure):
        return bitset.bit_get(closure, rows, cols)
    r = closure.region
    inside = (rows < r) & (cols < r)
    got = bitset.bit_get(closure.tiles, torch.clamp(rows, max=r - 1),
                         torch.clamp(cols, max=r - 1))
    return got & inside


def grow_cache(cache: ClosureCache, new_capacity: int) -> ClosureCache:
    """Re-embed the cache at a larger capacity: the grown graph is the old
    graph plus isolated free slots, so the clean/dirty status and the
    repair-depth EMA carry over unchanged."""
    c = cache.capacity
    if new_capacity == c:
        return cache
    if new_capacity < c:
        raise ValueError(
            f"cannot shrink: new capacity {new_capacity} < current {c}")
    return ClosureCache(grow_closure(cache.closure, new_capacity),
                        cache.dirty, cache.repair_ema)


def rebuild_cache(adj_packed: torch.Tensor,
                  matmul_impl: Optional[MatmulImpl] = None) -> ClosureCache:
    """From-scratch rebuild: the lazy-revalidation (and test-oracle) path."""
    return ClosureCache(transitive_closure(adj_packed, matmul_impl), False,
                        _ema0())


def refresh_closure(closure, dirty: bool, adj_packed: torch.Tensor,
                    matmul_impl: Optional[MatmulImpl] = None):
    """(trusted closure, n_products): rebuilds iff dirty, charging the
    rebuild's boolean-matmul products.  A tiled closure rebuilds inside
    its window, and only when the adjacency is region-confined; otherwise
    its tiles stay as they are (stale), as in the reference."""
    if is_tiled(closure):
        r = closure.region
        if dirty and region_confined(adj_packed, r):
            tiles, n = transitive_closure(region_window(adj_packed, r),
                                          matmul_impl, with_stats=True)
            return TiledClosure(tiles, build_summary(tiles,
                                                     closure.capacity)), n
        return closure, 0
    if dirty:
        return transitive_closure(adj_packed, matmul_impl, with_stats=True)
    return closure, 0


# ------------------------------------------------------------ typed deltas

class CacheDelta(NamedTuple):
    """The typed mutation record every engine mutator emits.  All masks
    are adjacency-diff exact (see `repro.core.closure_cache.CacheDelta`)."""

    add_u: torch.Tensor        # int32[Ba]: accepted edge sources (slots)
    add_v: torch.Tensor        # int32[Ba]: accepted edge targets (slots)
    add_mask: torch.Tensor     # bool[Ba]: which rows fold in
    rem_u: torch.Tensor        # int32[Br]: removed edge sources (slots)
    rem_v: torch.Tensor        # int32[Br]: removed edge targets (slots)
    rem_mask: torch.Tensor     # bool[Br]: which rows actually cleared a bit
    clear_slots: torch.Tensor  # int32[Bc]: removed-vertex slots
    clear_mask: torch.Tensor   # bool[Bc]: which removals touched adjacency

    @staticmethod
    def _none(like: torch.Tensor):
        return (torch.zeros((0,), dtype=torch.int32, device=like.device),
                torch.zeros((0,), dtype=torch.bool, device=like.device))

    @classmethod
    def edges_added(cls, u_slots, v_slots, mask) -> "CacheDelta":
        e, m = cls._none(u_slots)
        return cls(u_slots, v_slots, mask, e, e, m, e, m)

    @classmethod
    def edges_removed(cls, u_slots, v_slots, mask) -> "CacheDelta":
        e, m = cls._none(u_slots)
        return cls(e, e, m, u_slots, v_slots, mask, e, m)

    @classmethod
    def vertices_cleared(cls, slots, mask) -> "CacheDelta":
        e, m = cls._none(slots)
        return cls(e, e, m, e, e, m, slots, mask)

    @classmethod
    def merge(cls, *deltas: "CacheDelta") -> "CacheDelta":
        """Concatenate several same-tick deltas into ONE (field-wise);
        exact for a phase-ordered run (every delete before every add)."""
        return cls(*[torch.cat([d[i] for d in deltas])
                     for i in range(len(cls._fields))])

    def removal_seeds(self):
        """(seeds int32[Br+Bc], mask bool[Br+Bc]): the slots whose
        ancestor rows need re-derivation (a removed edge's source, a
        removed vertex)."""
        return (torch.cat([self.rem_u, self.clear_slots]),
                torch.cat([self.rem_mask, self.clear_mask]))


def _column_bits(closure: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """bool[C, B]: closure[:, slots[b]] — one gather + shift per slot."""
    word = (slots >> 5).long()
    return ((closure[:, word] >> (slots & 31)[None, :]) & 1) != 0


def affected_rows(closure: torch.Tensor, seeds: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """bool[C]: rows whose reach sets a removal at ``seeds`` can shrink —
    the ancestors of each enabled seed (its closure column) plus the seed."""
    c = closure.shape[0]
    if seeds.shape[0] == 0:
        return torch.zeros((c,), dtype=torch.bool, device=closure.device)
    anc = _column_bits(closure, seeds)                               # (C, B)
    is_seed = torch.arange(c, dtype=torch.int32,
                           device=closure.device)[:, None] == seeds[None, :]
    return torch.any((anc | is_seed) & mask[None, :], dim=1)


def masked_delete_scan(adj_after: torch.Tensor, closure: torch.Tensor,
                       affected: torch.Tensor, hop_impl=None):
    """Re-derive the affected rows of a delete-maintained closure.

    The hop matrix ``S = where(affected, adj_after, closure)`` lets a
    frontier jump through an unaffected row's still-exact closure row in
    one step, so the fixpoint ``R <- R | R @ S`` from ``R = S`` converges
    at the depth of the longest chain through affected vertices.

    ``hop_impl`` is one hop: (R, S, affected_packed (W,)) -> next R;
    default `kernels/ops.closure_delete` (kernel B3 on CUDA tensors).
    Returns (closure', n_products, row_products) with ints for the counts;
    row_products counts only the affected rows each product re-derives.
    """
    hop = hop_impl if hop_impl is not None else ops.closure_delete
    s = torch.where(affected[:, None], adj_after, closure)
    affp = bitset.pack_bits(affected)
    n_aff = int(torch.sum(affected, dtype=torch.int32))
    r, n = s, 0
    changed = n_aff > 0
    while changed:
        rn = hop(r, s, affp)
        changed = bool(torch.any(rn != r))
        r = rn
        n += 1
    return r, n, n * n_aff


def _repair_ema_update(ema: torch.Tensor, depth: int,
                       ema_alpha: float) -> torch.Tensor:
    d = torch.tensor(float(depth), dtype=torch.float32)
    return torch.where(ema > 0, (1.0 - ema_alpha) * ema + ema_alpha * d, d)


def _window_repair(tiled: TiledClosure, adj_window: torch.Tensor,
                   affected: torch.Tensor,
                   delete_impl: Optional[DeleteScanImpl]):
    """The delete repair on a tiles window -> (TiledClosure, n_products,
    row_products).  With no override, each hop is kernel B5 on the card,
    and the summary comes from the last hop's occupancy plane (the
    converged hop's output is the result); an override pays one
    `build_summary` pass."""
    cap = tiled.capacity
    if delete_impl is not None:
        tiles, n, rows = delete_impl(adj_window, tiled.tiles, affected)
        return TiledClosure(tiles, build_summary(tiles, cap)), n, rows
    last_occ = {}

    def hop(r, s, affp):
        out, last_occ["occ"] = ops.closure_delete_tiled(r, s, affp)
        return out

    tiles, n, rows = masked_delete_scan(adj_window, tiled.tiles, affected,
                                        hop_impl=hop)
    summary = summary_from_occ(last_occ["occ"], cap) if last_occ \
        else build_summary(tiles, cap)
    return TiledClosure(tiles, summary), n, rows


def _clip_seeds(seeds: torch.Tensor, smask: torch.Tensor, region: int):
    """(seeds clamped into the window, mask of enabled in-window seeds,
    whether an enabled seed lies past the window)."""
    in_region = seeds < region
    blocked = bool(torch.any(smask & ~in_region))
    return torch.clamp(seeds, max=region - 1), smask & in_region, blocked


def commit(cache: ClosureCache, delta: CacheDelta, adj_after: torch.Tensor,
           *, update_impl: Optional[ClosureUpdateImpl] = None,
           delete_impl: Optional[DeleteScanImpl] = None,
           prefer_repair_fn=None, ema_alpha: float = 0.25,
           with_stats: bool = False):
    """The single entry point applying a typed `CacheDelta` to the cache.

    Delete side first: on a clean cache with any adjacency-touching
    removal, ``prefer_repair_fn(n_affected, repair_ema)`` (default:
    `dispatch.prefer_delete_repair`, priced against the window's rows on
    the tiled layout) picks the masked affected-row re-derivation (cache
    stays clean) or invalidation.  A dirty cache commits removals as a
    no-op.  Adds then fold in with the rank-B update (skipped on a dirty
    cache).  On the tiled layout an enabled removal seed past the window
    forces invalidation, and an accepted edge past it skips the fold and
    marks the cache dirty (degrade-to-dirty).  Returns ``cache'`` or
    ``(cache', stats)`` with n_products / row_products / n_repair ints."""
    closure, dirty, ema = cache.closure, cache.dirty, cache.repair_ema
    tiled = is_tiled(closure)
    region = closure.region if tiled else closure.shape[0]
    work = closure.tiles if tiled else closure
    n_products = row_products = n_repair = 0
    seeds, smask = delta.removal_seeds()
    if seeds.shape[0]:
        any_removed = bool(torch.any(smask))
        blocked = False
        if tiled:
            seeds, smask, blocked = _clip_seeds(seeds, smask, region)
        affected = affected_rows(work, seeds, smask)
        n_aff = torch.sum(affected, dtype=torch.int32)
        if prefer_repair_fn is None:
            from repro_torch.core import dispatch

            def prefer_repair_fn(n, depth_hint):
                return dispatch.prefer_delete_repair(n, region, depth_hint)

        if not dirty and any_removed and not blocked \
                and bool(prefer_repair_fn(n_aff, ema)):
            if tiled:
                closure, n_products, row_products = _window_repair(
                    closure, region_window(adj_after, region), affected,
                    delete_impl)
            else:
                scan = delete_impl if delete_impl is not None \
                    else masked_delete_scan
                closure, n_products, row_products = scan(adj_after, closure,
                                                         affected)
            ema = _repair_ema_update(ema, n_products, ema_alpha)
            dirty, n_repair = False, 1
        else:
            dirty = dirty or any_removed
    if delta.add_u.shape[0] and not dirty:
        if tiled:
            closure, dirty = insert_update_tiled(
                closure, delta.add_u, delta.add_v, delta.add_mask,
                update_impl)
        elif bool(torch.any(delta.add_mask)):
            closure = insert_update(closure, delta.add_u, delta.add_v,
                                    delta.add_mask, update_impl)
    out = ClosureCache(closure, dirty, ema)
    if with_stats:
        return out, {"n_products": n_products, "row_products": row_products,
                     "n_repair": n_repair}
    return out


def apply_delta(closure, adj_after: torch.Tensor, delta: CacheDelta, *,
                update_impl: Optional[ClosureUpdateImpl] = None,
                delete_impl: Optional[DeleteScanImpl] = None):
    """Reader-side application of one shipped `CacheDelta`: no dispatch
    arm, no dirty flag, no cycle check — removals repair against the
    post-delta adjacency, adds fold in.  Idempotent.  A tiled closure
    applies inside its window (the caller widens it first to cover every
    slot the delta addresses)."""
    tiled = is_tiled(closure)
    region = closure.region if tiled else closure.shape[0]
    seeds, smask = delta.removal_seeds()
    if seeds.shape[0]:
        if tiled:
            seeds, smask, _ = _clip_seeds(seeds, smask, region)
            affected = affected_rows(closure.tiles, seeds, smask)
            closure, _, _ = _window_repair(
                closure, region_window(adj_after, region), affected,
                delete_impl)
        else:
            affected = affected_rows(closure, seeds, smask)
            scan = delete_impl if delete_impl is not None \
                else masked_delete_scan
            closure, _, _ = scan(adj_after, closure, affected)
    if delta.add_u.shape[0] and bool(torch.any(delta.add_mask)):
        if tiled:
            closure = _fold_window(
                closure, torch.clamp(delta.add_u, max=region - 1),
                torch.clamp(delta.add_v, max=region - 1), delta.add_mask,
                update_impl)
        else:
            closure = insert_update(closure, delta.add_u, delta.add_v,
                                    delta.add_mask, update_impl)
    return closure


# --------------------------------------------------- candidate hop graph

def _closure_bool_small(a: torch.Tensor, strict: bool = True) -> torch.Tensor:
    """Transitive closure of a small dense bool[B, B] matrix by repeated
    squaring in float32 (B is a candidate batch, not the capacity)."""
    b = a.shape[0]
    n_iter = closure_iteration_bound(b)
    if not strict:
        a = a | torch.eye(b, dtype=torch.bool, device=a.device)
    r = a
    for _ in range(n_iter):
        rf = r.to(torch.float32)
        r = r | ((rf @ rf) > 0)
    return r


def candidate_hop_matrix(closure, u_slots: torch.Tensor,
                         v_slots: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """A[i, j] = mask[i] & mask[j] & "candidate i's target reaches
    candidate j's source through the committed graph (>= 0 edges)".  A
    tiled closure reads its window; out-of-window slots contribute no
    reach bits (exact under confinement)."""
    if is_tiled(closure):
        r = closure.region
        v_in, u_in = v_slots < r, u_slots < r
        rows_v = torch.where(
            v_in[:, None],
            closure.tiles[torch.clamp(v_slots, max=r - 1).long()], 0)
        reach = _column_bits(rows_v, torch.clamp(u_slots, max=r - 1)) \
            & u_in[None, :]
    else:
        rows_v = closure[v_slots.long()]                          # (B, W)
        reach = _column_bits(rows_v, u_slots)
    hop = reach | (v_slots[:, None] == u_slots[None, :])
    return hop & mask[:, None] & mask[None, :]


def incremental_cycle_check(closure, u_slots: torch.Tensor,
                            v_slots: torch.Tensor,
                            cand: torch.Tensor) -> torch.Tensor:
    """cyc[b] = True iff candidate edge (u_b, v_b) lies on a cycle of
    ``G ∪ transit`` — B^2 bit reads + one B x B closure."""
    hop = candidate_hop_matrix(closure, u_slots, v_slots, cand)
    return torch.diagonal(_closure_bool_small(hop, strict=True)) & cand


# --------------------------------------------------------- rank-B update

def _pad32(n: int) -> int:
    return ((n + 31) // 32) * 32


def chunked_update_impl(block_rows: int = 1024) -> ClosureUpdateImpl:
    """Memory-bounded plain realization of the rank-B update: streams the
    closure in ``block_rows``-row blocks, bounding the transient float
    product at O(block_rows * C) while computing the identical result."""
    def impl(closure: torch.Tensor, mask_packed: torch.Tensor,
             rows_packed: torch.Tensor) -> torch.Tensor:
        c = closure.shape[0]
        r = min(block_rows, c)
        if c % r != 0:  # fall back rather than pad the row axis
            return ops.closure_update(closure, mask_packed, rows_packed,
                                      impl="ref")
        rows = bitset.unpack_bits(rows_packed).to(torch.float32)  # (B, C)
        out = [cl_blk | bitset.pack_bits(
                   (bitset.unpack_bits(m_blk).to(torch.float32) @ rows) > 0)
               for cl_blk, m_blk in zip(closure.split(r), mask_packed.split(r))]
        return torch.cat(out)

    return impl


def insert_update(closure: torch.Tensor, u_slots: torch.Tensor,
                  v_slots: torch.Tensor, accepted: torch.Tensor,
                  update_impl: Optional[ClosureUpdateImpl] = None
                  ) -> torch.Tensor:
    """Fold a jointly-acyclic accepted edge batch into the strict closure:
    ``old | L @ Sstar @ R`` with L[w, j] = "w reaches u_j", Sstar the hop
    graph's reflexive-transitive closure and R[j] = closure[v_j] |
    onehot(v_j).  ``L @ Sstar`` collapses into the mask, so the heavy
    (C x B) x (B x C) OR-accumulate is ONE call of ``update_impl``
    (kernel B2 on the card)."""
    impl = update_impl if update_impl is not None else ops.closure_update
    c = closure.shape[0]
    b = u_slots.shape[0]
    dev = closure.device

    hop = candidate_hop_matrix(closure, u_slots, v_slots, accepted)
    sstar = _closure_bool_small(hop, strict=False)

    # L[w, j] = accepted[j] & (w == u_j | closure[w, u_j])
    reaches_u = _column_bits(closure, u_slots)
    is_u = torch.arange(c, dtype=torch.int32, device=dev)[:, None] \
        == u_slots[None, :]
    l_mask = (reaches_u | is_u) & accepted[None, :]

    # mask = L @ Sstar (C x B bool — small next to the rank-B update)
    mask = (l_mask.to(torch.float32) @ sstar.to(torch.float32)) > 0

    # R[j] = closure[v_j] | onehot(v_j), zeroed for rejected rows
    rows = closure[v_slots.long()] | bitset.onehot_rows(v_slots, c)
    rows = torch.where(accepted[:, None], rows, 0)

    # pad B to a word multiple for the packed-mask kernel layout
    bp = _pad32(b)
    if bp != b:
        mask = torch.nn.functional.pad(mask, (0, bp - b))
        rows = torch.nn.functional.pad(rows, (0, 0, 0, bp - b))
    return impl(closure, bitset.pack_bits(mask), rows.contiguous())


def _fold_window(closure: TiledClosure, u_slots: torch.Tensor,
                 v_slots: torch.Tensor, accepted: torch.Tensor,
                 update_impl: Optional[ClosureUpdateImpl]) -> TiledClosure:
    """`insert_update` on the tiles window (slots already inside it).  With
    no override the fold is kernel B4 on the card and the summary comes
    from its occupancy plane; an override pays one `build_summary`
    pass."""
    cap = closure.capacity
    if update_impl is not None:
        tiles = insert_update(closure.tiles, u_slots, v_slots, accepted,
                              update_impl)
        return TiledClosure(tiles, build_summary(tiles, cap))
    occ = {}

    def fused(cl, mask_packed, rows_packed):
        out, occ["occ"] = ops.closure_update_tiled(cl, mask_packed,
                                                   rows_packed)
        return out

    tiles = insert_update(closure.tiles, u_slots, v_slots, accepted, fused)
    return TiledClosure(tiles, summary_from_occ(occ["occ"], cap))


def insert_update_tiled(closure: TiledClosure, u_slots: torch.Tensor,
                        v_slots: torch.Tensor, accepted: torch.Tensor,
                        update_impl: Optional[ClosureUpdateImpl] = None):
    """The rank-B fold on the tiled layout -> ``(closure', spilled)``.  An
    accepted edge with an endpoint past the window cannot fold into the
    tiles, so the whole fold is skipped and ``spilled=True`` tells the
    caller to mark the cache dirty."""
    r = closure.region
    spill = bool(torch.any(accepted & ((u_slots >= r) | (v_slots >= r))))
    if spill or not bool(torch.any(accepted)):
        return closure, spill
    return _fold_window(closure, torch.clamp(u_slots, max=r - 1),
                        torch.clamp(v_slots, max=r - 1), accepted,
                        update_impl), False


# -------------------------------------------------------------- validation

def cache_matches_state(cache: ClosureCache, adj_packed: torch.Tensor,
                        matmul_impl: Optional[MatmulImpl] = None) -> bool:
    """True iff a clean cache's closure equals the from-scratch closure of
    ``adj_packed`` (dirty caches vacuously match).  A tiled cache also
    checks its summary against its tiles, and squares only its window:
    the closure of a region-confined graph is confined to the window,
    and a graph with a bit past the window has closure bits there that
    the tiles cannot hold, so it cannot match."""
    if not is_tiled(cache.closure):
        want = transitive_closure(adj_packed, matmul_impl)
        return cache.dirty or bool(torch.equal(cache.closure, want))
    tiled = cache.closure
    if cache.dirty:
        return True
    if not region_confined(adj_packed, tiled.region):
        return False
    want = transitive_closure(region_window(adj_packed, tiled.region),
                              matmul_impl)
    return bool(torch.equal(tiled.tiles, want)) and bool(torch.equal(
        tiled.summary, build_summary(tiled.tiles, tiled.capacity)))
