"""Versioned wait-free read view of a `DagEngine` session, in torch.

Port of `repro.core.snapshot_view`.  `EngineSnapshot` holds the epoch
that names the graph version, the `DagState` slab view and the CLEAN
packed transitive closure (the dense slab or a
`closure_cache.TiledClosure`) — references to the engine's tensors, which
the engine never writes again, so a snapshot costs no copy and later
writer mutations (new engines) never change it.  Every read is a bit
read: ``reachable`` does zero boolean-matmul row products.
"""
from __future__ import annotations

import torch

from repro_torch.core import closure_cache
from repro_torch.core import dag as dag_mod


class EngineSnapshot:
    """Frozen read-only view of one engine version (no mutators)."""

    __slots__ = ("epoch", "state", "closure")

    def __init__(self, epoch: int, state: dag_mod.DagState, closure):
        self.epoch = epoch      # engine version at capture
        self.state = state      # DagState slab view (keys/alive/adj)
        # clean packed strict closure: dense int32[C, W], or a
        # closure_cache.TiledClosure (region-windowed tiles + summary)
        self.closure = closure

    def __repr__(self):
        return (f"EngineSnapshot(epoch={self.epoch}, "
                f"capacity={self.capacity})")

    @property
    def capacity(self) -> int:
        return self.state.capacity

    def contains(self, keys) -> torch.Tensor:
        """ContainsVertex batch -> bool[B] (key-table lookup)."""
        return dag_mod.contains_vertices(self.state, self._keys(keys))

    def contains_edges(self, us, vs) -> torch.Tensor:
        """ContainsEdge batch -> bool[B] (adjacency bit reads)."""
        return dag_mod.contains_edges(self.state, self._keys(us),
                                      self._keys(vs))

    def reachable(self, from_keys, to_keys, with_stats: bool = False):
        """Batch PathExists(from, to) answered off the clean closure — no
        scan, no matmul.  ``with_stats=True`` also returns a
        `core/engine.ReachStats` whose products are structurally zero."""
        f_slot, f_found = dag_mod.lookup_slots(self.state,
                                               self._keys(from_keys))
        t_slot, t_found = dag_mod.lookup_slots(self.state,
                                               self._keys(to_keys))
        hit = f_found & t_found & closure_cache.closure_bit_get(
            self.closure, f_slot, t_slot)
        if not with_stats:
            return hit
        from repro_torch.core.engine import ReachStats  # circular at import
        return hit, ReachStats.zeros()

    def live_vertex_count(self) -> torch.Tensor:
        return dag_mod.live_vertex_count(self.state)

    def edge_count(self) -> torch.Tensor:
        return dag_mod.edge_count(self.state)

    def is_acyclic(self) -> torch.Tensor:
        """Answered off the closure diagonal in O(C) bit reads."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.state.device)
        return ~torch.any(closure_cache.closure_bit_get(self.closure, idx,
                                                        idx))

    def _keys(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32,
                               device=self.state.device)
