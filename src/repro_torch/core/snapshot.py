"""Partial-snapshot reachability — the paper's Algorithm 2, in torch.

Port of `repro.core.snapshot`.  Only the reach sets seeded from the
candidate edges' target slots are collected, one boolean product of B
rows per hop, and each query's frontier is killed the moment it is
decided (target hit, or frontier died).  The loop ends at the deciding
depth; ``n_products`` and the per-query ``decided_at`` equal the
reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitset
from repro_torch.core.dag import DagState
from repro_torch.core.reachability import MatmulImpl, _impl


def reach_until_decided(adj_packed: torch.Tensor,
                        sources_packed: torch.Tensor,
                        target_slots: torch.Tensor,
                        matmul_impl: Optional[MatmulImpl] = None,
                        with_stats: bool = False,
                        with_depths: bool = False):
    """Batched decided-early-exit reachability.

    hit[b] = True iff a path of >= 1 edge leads from any vertex in
    ``sources_packed[b]`` to ``target_slots[b]``.  ``with_stats`` adds the
    number of products (an int); ``with_depths`` also the per-query
    deciding hop int32[B] (0 for never-seeded rows)."""
    impl = _impl(matmul_impl)
    b = sources_packed.shape[0]
    dev = sources_packed.device
    rows = torch.arange(b, device=dev)
    reach = torch.zeros_like(sources_packed)
    frontier = sources_packed
    hit = torch.zeros((b,), dtype=torch.bool, device=dev)
    decided_at = torch.zeros((b,), dtype=torch.int32, device=dev)
    n = 0
    alive = torch.any(frontier != 0, dim=-1)
    while bool(torch.any(alive)):
        new = impl(frontier, adj_packed) & ~reach
        reach = reach | new
        hit = hit | bitset.bit_get(reach, rows, target_slots)
        # kill decided frontiers: no further expansion for answered queries
        frontier = torch.where(hit[:, None], 0, new)
        still = torch.any(frontier != 0, dim=-1)
        decided_at = torch.where(alive & ~still, n + 1, decided_at)
        alive = still
        n += 1
    if with_depths:
        return hit, n, decided_at
    if with_stats:
        return hit, n
    return hit


def partial_cycle_check(adj_packed: torch.Tensor, u_slots: torch.Tensor,
                        v_slots: torch.Tensor, cand: torch.Tensor,
                        matmul_impl: Optional[MatmulImpl] = None,
                        with_stats: bool = False,
                        with_depths: bool = False):
    """cyc[b] = True iff a path v_slots[b] -> u_slots[b] exists in
    ``adj_packed`` and cand[b].  Non-candidate rows get zero seeds."""
    src = bitset.onehot_rows(v_slots, adj_packed.shape[0])
    src = torch.where(cand[:, None], src, 0)
    return reach_until_decided(adj_packed, src, u_slots, matmul_impl,
                               with_stats=with_stats,
                               with_depths=with_depths)


def path_exists_partial(state: DagState, from_keys: torch.Tensor,
                        to_keys: torch.Tensor,
                        matmul_impl: Optional[MatmulImpl] = None
                        ) -> torch.Tensor:
    """Batch PathExists via the partial-snapshot scan: same answers as
    `reachability.path_exists`, each query stopping at its deciding
    depth."""
    from repro_torch.core.reachability import seed_path_queries

    src, t_slot, endpoints_ok = seed_path_queries(state, from_keys, to_keys)
    hit = reach_until_decided(state.adj, src, t_slot, matmul_impl)
    return endpoints_ok & hit
