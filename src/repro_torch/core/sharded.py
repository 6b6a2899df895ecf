"""Multi-device sharded DAG engine, in torch: one process driving a mesh of
row shards.

Port of `repro.core.sharded`.  The reference partitions the adjacency's
vertex rows over a 1-D device mesh and spells out each collective schedule
with ``shard_map``, one process driving every shard.  Here a `DagMesh` is
a tuple of D torch devices, one per row shard; it may name one device D
times (``make_dag_mesh(n_shards=D)``, the counterpart of the reference's
``--xla_force_host_platform_device_count``).

The engine's state stays whole tensors on the mesh's first device, the
counterpart of a ``jax.Array`` whose rows a ``NamedSharding`` places.  A
schedule takes shard d's rows with ``narrow``: a view, not a copy, when the
shard's device is the tensor's.  A block moves to its shard's device only
when the two differ.  So a mesh of one repeated card copies no operand,
and a mesh over several cards is correct but copies each shard's blocks to
its card and back on every call (blocks that stay resident across cards
are an open item of ROADMAP.md).

Each shard's product is one call of a `kernels.ops` dispatcher on its own
row block: kernel B1 (`bitmm_packed`), B2 (`closure_update`) or B3
(`closure_delete`) on a CUDA tensor, the plain version on the CPU.  Every
cross-shard data movement of the reference's ``shard_map`` bodies goes
through the four collectives `_all_gather_rows`, `_or_reduce`, `_psum` and
`_pmax`.

Schedules (C the capacity, W = C/32 words, D shards, C % (32 D) == 0):
  frontier hop   B1 on each shard's (B, W/D) word columns of the frontier
                 x its (C/D, W) adjacency rows -> (B, W) partials, ORed
                 (the reference sums float counts and tests > 0: the same
                 bits)
  batch hop      B1 on each shard's B/D frontier rows x the whole
                 adjacency; no per-hop reduction (requires B % D == 0)
  closure step   R gathered; B1 on each shard's (C/D, W) rows x R
  rank-B fold    B2 on each shard's closure and mask rows, the B
                 contributed rows replicated: zero collectives
  delete repair  S = where(affected, adj_after, closure) built once; B3
                 looped on each shard's rows to its own block's fixpoint;
                 one pmax / psum of the hop counters
A row split falls on 32-row word boundaries; rows that do not divide into
D equal word blocks (a replica's widened tiles window) split as evenly as
the words allow.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import acyclic, bitset, closure_cache, dispatch, snapshot
from repro_torch.core.dag import DagState
from repro_torch.core.reachability import closure_iteration_bound
from repro_torch.core.snapshot_view import EngineSnapshot
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DagMesh:
    """A 1-D mesh of row shards: shard d's rows live on ``devices[d]``.
    The engine's whole tensors live on ``devices[0]``."""

    devices: Tuple[torch.device, ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass devices=['cpu'] to build "
                "a mesh of CPU shards")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_dag_mesh(devices=None, n_shards=None) -> DagMesh:
    """A mesh over ``devices`` (a device, or a sequence of them; default:
    every visible CUDA device, raising when none is present).
    ``n_shards=D`` repeats one device D times (default: the current CUDA
    device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass devices=['cpu'] to build "
                "a mesh of CPU shards")
        ids = [torch.cuda.current_device()] if n_shards is not None \
            else range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in ids]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if n_shards is not None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if len(devs) != 1:
            raise ValueError(
                f"n_shards repeats one device; got {len(devs)} devices")
        devs = devs * n_shards
    return DagMesh(devs)


# ------------------------------------------------------------ collectives

def _on(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def _word_splits(n_words: int, n_shards: int) -> List[Tuple[int, int]]:
    """(first word, words) of each shard: as even as the words allow."""
    base, extra = divmod(n_words, n_shards)
    out, start = [], 0
    for d in range(n_shards):
        n = base + (1 if d < extra else 0)
        out.append((start, n))
        start += n
    return out


def _row_splits(n_rows: int, mesh: DagMesh) -> List[Tuple[int, int]]:
    """(first row, rows) of each shard's row block, on word boundaries."""
    if n_rows % bitset.WORD:
        raise ValueError(f"{n_rows} rows do not split on 32-row words")
    return [(s * bitset.WORD, n * bitset.WORD)
            for s, n in _word_splits(n_rows // bitset.WORD, mesh.n_devices)]


def _row_blocks(x: torch.Tensor, mesh: DagMesh) -> List[torch.Tensor]:
    """Each shard's row block of ``x``, on the shard's device (a view when
    the devices agree)."""
    return [_on(x.narrow(0, s, n), dev)
            for (s, n), dev in zip(_row_splits(x.shape[0], mesh),
                                   mesh.devices)]


def _all_gather_rows(parts: Sequence[torch.Tensor],
                     dev: torch.device) -> torch.Tensor:
    """Per-shard row blocks -> the whole tensor on ``dev``."""
    if len(parts) == 1:
        return _on(parts[0], dev)
    return torch.cat([_on(p, dev) for p in parts])


def _or_reduce(parts: Sequence[torch.Tensor],
               dev: torch.device) -> torch.Tensor:
    """Bitwise OR of per-shard partials, on ``dev``."""
    out = _on(parts[0], dev)
    for p in parts[1:]:
        out = out | _on(p, dev)
    return out


def _psum(values: Sequence[int]) -> int:
    return sum(int(v) for v in values)


def _pmax(values: Sequence[int]) -> int:
    return max(int(v) for v in values)


# -------------------------------------------------------------- placement

def _closure_on(closure, dev: torch.device):
    if closure_cache.is_tiled(closure):
        return closure_cache.TiledClosure(_on(closure.tiles, dev),
                                          _on(closure.summary, dev))
    return _on(closure, dev)


def _check_rows(n_rows: int, mesh: DagMesh, what: str) -> None:
    if n_rows % (bitset.WORD * mesh.n_devices):
        raise ValueError(
            f"{what} rows {n_rows} must be a multiple of "
            f"{bitset.WORD * mesh.n_devices} (32 bits x {mesh.n_devices} "
            "shards)")


def shard_state(state: DagState, mesh: DagMesh) -> DagState:
    """The slab on the mesh: its tensors on the mesh's first device, the
    adjacency's rows split evenly over the shards."""
    _check_rows(state.capacity, mesh, "adjacency")
    return DagState(*(_on(x, mesh.home) for x in state))


def shard_closure(closure, mesh: DagMesh):
    """A packed closure on the mesh: dense slabs and tiles windows split
    their rows like the adjacency; a tiled closure's occupancy summary
    stays whole (every shard reads it)."""
    rows = closure.tiles.shape[0] if closure_cache.is_tiled(closure) \
        else closure.shape[0]
    _check_rows(rows, mesh, "closure")
    return _closure_on(closure, mesh.home)


def shard_cache(cache, mesh: DagMesh):
    """An incremental closure cache on the mesh: its closure as
    `shard_closure` places it; the dirty flag and the repair-depth EMA are
    host values."""
    return cache._replace(closure=shard_closure(cache.closure, mesh))


def replicate_snapshot(mesh: DagMesh, snap) -> tuple:
    """One read view of an `EngineSnapshot` on each shard's device (the
    same tensors where the device is the snapshot's): every shard answers
    its reads from its own copy, with no cross-shard traffic."""
    return tuple(EngineSnapshot(snap.epoch,
                                DagState(*(_on(x, dev) for x in snap.state)),
                                _closure_on(snap.closure, dev))
                 for dev in mesh.devices)


def shard_replica(mesh: DagMesh, replica):
    """A replica on the mesh, replaying with the writer's schedules: its
    adjacency mirror and closure split their rows over the shards, and its
    delta apply runs `closure_update_impl` / `closure_delete_impl`."""
    from repro_torch.replica import Replica

    _check_rows(replica.adj.shape[0], mesh, "adjacency")
    return Replica(replica.epoch, _on(replica.adj, mesh.home),
                   shard_closure(replica.closure, mesh),
                   closure_update_impl(mesh), closure_delete_impl(mesh))


# ------------------------------------------------------------- schedules

def closure_update_impl(mesh: DagMesh):
    """The row-sharded rank-B fold ``out[w] = closure[w] | OR_{j: mask[w,
    j]} rows[j]``: B2 on each shard's closure and mask rows against the
    replicated contributed rows, zero collectives."""
    def impl(closure, mask_packed, rows_packed):
        parts = [ops.closure_update(cl, m, _on(rows_packed, dev))
                 for cl, m, dev in zip(_row_blocks(closure, mesh),
                                       _row_blocks(mask_packed, mesh),
                                       mesh.devices)]
        return _all_gather_rows(parts, closure.device)

    return impl


def closure_delete_impl(mesh: DagMesh):
    """The row-sharded delete-repair masked scan (`closure_cache.
    masked_delete_scan`'s signature): the hop matrix S is fixed for the
    whole scan and replicated once; each shard loops B3 on its own rows
    with its own affected mask and stops at its own block's fixpoint (a
    block with no affected row runs no hop).  Returns (closure', the
    largest shard hop count, the sum over shards of hops x affected
    rows), as the reference's ``pmax`` / ``psum``."""
    def impl(adj_after, closure, affected):
        s = torch.where(affected[:, None], adj_after, closure)
        parts, hops, work = [], [], []
        for s_loc, aff, dev in zip(_row_blocks(s, mesh),
                                   _row_blocks(affected, mesh),
                                   mesh.devices):
            s_full = _on(s, dev)
            affp = bitset.pack_bits(aff)
            n_aff = int(torch.sum(aff, dtype=torch.int32))
            r, i = s_loc, 0
            changed = n_aff > 0
            while changed:
                rn = ops.closure_delete(r, s_full, affp)
                changed = bool(torch.any(rn != r))
                r = rn
                i += 1
            parts.append(r)
            hops.append(i)
            work.append(i * n_aff)
        return (_all_gather_rows(parts, closure.device), _pmax(hops),
                _psum(work))

    return impl


def expand_frontier_sharded(mesh: DagMesh, adj: torch.Tensor,
                            frontier: torch.Tensor) -> torch.Tensor:
    """One hop: frontier (B, W) x adj (C, W) -> (B, W).  Each shard
    multiplies its word columns of the frontier by its adjacency rows;
    the partials are ORed."""
    parts = []
    for (s, n), dev in zip(_word_splits(frontier.shape[1], mesh.n_devices),
                           mesh.devices):
        if n == 0:
            continue
        f_loc = _on(frontier.narrow(1, s, n).contiguous(), dev)
        a_loc = _on(adj.narrow(0, s * bitset.WORD, n * bitset.WORD), dev)
        parts.append(ops.bitmm_packed(f_loc, a_loc))
    return _or_reduce(parts, frontier.device)


def _batch_rows_product(mesh: DagMesh, lhs: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """lhs rows split evenly over the shards, rhs replicated: B1 on each
    shard's rows, no reduction."""
    n = lhs.shape[0] // mesh.n_devices
    parts = [ops.bitmm_packed(_on(lhs.narrow(0, d * n, n), dev),
                              _on(rhs, dev))
             for d, dev in enumerate(mesh.devices)]
    return _all_gather_rows(parts, lhs.device)


def reach_sets_sharded(mesh: DagMesh, adj: torch.Tensor,
                       sources: torch.Tensor) -> torch.Tensor:
    """Multi-source strict reach sets with the frontier schedule."""
    frontier = expand_frontier_sharded(mesh, adj, sources)
    reach = frontier
    while bool(torch.any(frontier != 0)):
        new = expand_frontier_sharded(mesh, adj, frontier) & ~reach
        reach = reach | new
        frontier = new
    return reach


def reach_until_decided_sharded(mesh: DagMesh, adj: torch.Tensor,
                                sources: torch.Tensor,
                                target_slots: torch.Tensor) -> torch.Tensor:
    """The partial-snapshot scan (`snapshot.reach_until_decided`) with the
    frontier schedule for each hop; decided queries drop out."""
    return snapshot.reach_until_decided(
        adj, sources, target_slots,
        matmul_impl=lambda f, a: expand_frontier_sharded(mesh, a, f))


def reach_until_decided_batch_sharded(mesh: DagMesh, adj: torch.Tensor,
                                      sources: torch.Tensor,
                                      target_slots: torch.Tensor
                                      ) -> torch.Tensor:
    """The B-sharded partial scan: each shard runs the whole scan on its
    B/D query rows against the replicated adjacency, with no per-hop
    collective, and exits at its own rows' deciding depth.  Requires
    B % D == 0."""
    n_dev = mesh.n_devices
    b = sources.shape[0]
    if b % n_dev != 0:
        raise ValueError(f"batch {b} not divisible by mesh size {n_dev}")
    n = b // n_dev
    hits = [snapshot.reach_until_decided(
                _on(adj, dev), _on(sources.narrow(0, d * n, n), dev),
                _on(target_slots.narrow(0, d * n, n), dev))
            for d, dev in enumerate(mesh.devices)]
    return _all_gather_rows(hits, sources.device)


def reach_until_decided_auto_sharded(mesh: DagMesh, adj: torch.Tensor,
                                     sources: torch.Tensor,
                                     target_slots: torch.Tensor
                                     ) -> torch.Tensor:
    """The partial scan with the schedule `dispatch.choose_scan_sharding`
    picks from B and the mesh size."""
    plan = dispatch.choose_scan_sharding(sources.shape[0], adj.shape[0],
                                         mesh.n_devices)
    if plan == "batch":
        return reach_until_decided_batch_sharded(mesh, adj, sources,
                                                 target_slots)
    return reach_until_decided_sharded(mesh, adj, sources, target_slots)


def partial_scan_matmul_impl(mesh: DagMesh, plan: str):
    """The per-hop product of a partial-scan schedule, for
    `snapshot.reach_until_decided` or `acyclic_add_edges_impl`'s
    ``partial_matmul_impl``: ``"frontier"`` splits the contraction,
    ``"batch"`` the frontier rows (B % D == 0, which
    `dispatch.choose_scan_sharding` guarantees before picking it)."""
    if plan == "frontier":
        return lambda frontier, adj: expand_frontier_sharded(mesh, adj,
                                                             frontier)
    if plan != "batch":
        raise ValueError(f'plan must be "batch" or "frontier", got {plan!r}')
    return lambda frontier, adj: _batch_rows_product(mesh, frontier, adj)


def engine_matmul_impl(mesh: DagMesh):
    """The sharded engine's boolean product for its closure squarings and
    full scans (the reference leaves these to GSPMD): lhs rows split over
    the shards when they divide evenly (a closure step: C/D rows a shard,
    the rhs gathered), otherwise the frontier schedule."""
    def impl(lhs, rhs):
        if lhs.shape[0] % mesh.n_devices == 0:
            return _batch_rows_product(mesh, lhs, rhs)
        return expand_frontier_sharded(mesh, rhs, lhs)

    return impl


def acyclic_add_edges_sharded(mesh: DagMesh, state: DagState,
                              us: torch.Tensor, vs: torch.Tensor, valid=None,
                              subbatches: int = 1, policy=None,
                              matmul_impl=None, with_stats: bool = False,
                              cache=None):
    """AcyclicAddEdge on the mesh, routed through the dispatch policy
    (default `dispatch.CostModelPolicy`): closure vs partial per
    sub-batch as on one device, the partial branch on the scan schedule
    ``policy.scan_sharding`` picks, the closure branch on ``matmul_impl``
    (default: the row-sharded product), and with ``cache`` (or a pinned
    ``FixedPolicy("incremental")``) the row-sharded rank-B fold."""
    policy = policy if policy is not None else dispatch.CostModelPolicy()
    b = us.shape[0]
    b_sub = max(1, b // subbatches)
    fixed = getattr(policy, "fixed_method", None)
    plan = policy.scan_sharding(b_sub, state.capacity, mesh.n_devices)
    closure_impl = matmul_impl if matmul_impl is not None \
        else engine_matmul_impl(mesh)
    return acyclic.acyclic_add_edges_impl(
        state, us, vs, valid=valid, subbatches=subbatches,
        method=fixed or "auto", matmul_impl=closure_impl,
        with_stats=with_stats,
        prefer_partial_fn=None if fixed else policy.prefer_partial,
        partial_matmul_impl=partial_scan_matmul_impl(mesh, plan),
        cache=cache, closure_update_impl=closure_update_impl(mesh),
        n_shards=mesh.n_devices,
        prefer_incremental_fn=None if fixed
        else getattr(policy, "prefer_incremental", None))


def transitive_closure_sharded(mesh: DagMesh,
                               adj: torch.Tensor) -> torch.Tensor:
    """Repeated squaring, ceil(log2 C) steps as the reference's
    ``fori_loop``: each step gathers R and runs B1 on every shard's
    (C/D, W) rows against it."""
    r = adj
    for _ in range(closure_iteration_bound(adj.shape[0])):
        parts = [blk | ops.bitmm_packed(blk, _on(r, dev))
                 for blk, dev in zip(_row_blocks(r, mesh), mesh.devices)]
        r = _all_gather_rows(parts, adj.device)
    return r


def is_acyclic_sharded(mesh: DagMesh, adj: torch.Tensor) -> torch.Tensor:
    t = transitive_closure_sharded(mesh, adj)
    idx = torch.arange(adj.shape[0], dtype=torch.int32, device=adj.device)
    return ~torch.any(bitset.bit_get(t, idx, idx))
