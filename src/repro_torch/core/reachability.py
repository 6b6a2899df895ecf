"""Wait-free reachability — Algorithm 1 of the paper, in torch.

Port of `repro.core.reachability`.  A batch of reachability queries runs
as frontier expansion: one hop == one boolean matrix product over packed
rows.  The transitive closure is computed by repeated squaring —
at most ceil(log2 C) products.

``matmul_impl`` defaults to `kernels.ops.bitmm_packed`, which launches
kernel B1 for CUDA tensors and runs the plain version for CPU tensors.
The reference's traced ``while_loop`` fixpoints are host loops here; the
iteration bounds and product counts are the reference's exactly.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core import bitset
from repro_torch.core.dag import DagState, lookup_slots
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bitmm_ref

MatmulImpl = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# the plain (unpack -> f32 matmul -> threshold -> pack) boolean product
bool_matmul_packed = bitmm_ref


def _impl(matmul_impl: Optional[MatmulImpl]) -> MatmulImpl:
    return matmul_impl or ops.bitmm_packed


def expand_frontier(adj_packed: torch.Tensor, frontier_packed: torch.Tensor,
                    matmul_impl: Optional[MatmulImpl] = None) -> torch.Tensor:
    return _impl(matmul_impl)(frontier_packed, adj_packed)


def reach_sets(adj_packed: torch.Tensor, sources_packed: torch.Tensor,
               matmul_impl: Optional[MatmulImpl] = None) -> torch.Tensor:
    """Multi-source reachability: (B, W) source bitsets -> (B, W) strict
    reach sets (vertices reachable via >= 1 edge)."""
    impl = _impl(matmul_impl)
    frontier = impl(sources_packed, adj_packed)  # 1 hop
    reach = frontier
    while bool(torch.any(frontier != 0)):
        new = impl(frontier, adj_packed) & ~reach
        reach = reach | new
        frontier = new
    return reach


def seed_path_queries(state: DagState, from_keys: torch.Tensor,
                      to_keys: torch.Tensor):
    """Shared PathExists query seeding: keys -> (packed source bitsets
    int32[B, W] with dead-key rows zeroed, target slots int32[B], and the
    both-endpoints-live mask bool[B])."""
    f_slot, f_found = lookup_slots(state, from_keys)
    t_slot, t_found = lookup_slots(state, to_keys)
    src = bitset.onehot_rows(f_slot, state.capacity)
    src = torch.where(f_found[:, None], src, 0)
    return src, t_slot, f_found & t_found


def path_exists(state: DagState, from_keys: torch.Tensor,
                to_keys: torch.Tensor,
                matmul_impl: Optional[MatmulImpl] = None) -> torch.Tensor:
    """Batch PathExists(from, to): True iff a path of >= 1 edge exists."""
    src, t_slot, endpoints_ok = seed_path_queries(state, from_keys, to_keys)
    reach = reach_sets(state.adj, src, matmul_impl)
    rows = torch.arange(from_keys.shape[0], device=reach.device)
    return endpoints_ok & bitset.bit_get(reach, rows, t_slot)


def closure_iteration_bound(capacity: int) -> int:
    """ceil(log2 C), floored at 1: the repeated-squaring iteration count
    (the single bound the closure loop and the cost model share)."""
    return max(1, math.ceil(math.log2(max(capacity, 2))))


def transitive_closure(adj_packed: torch.Tensor,
                       matmul_impl: Optional[MatmulImpl] = None,
                       with_stats: bool = False):
    """Strict transitive closure by repeated squaring with union, with
    early exit at the fixpoint (<= ceil(log2 C) products).  With
    ``with_stats`` also returns the number of products (an int)."""
    impl = _impl(matmul_impl)
    n_iter = closure_iteration_bound(adj_packed.shape[0])
    r = adj_packed
    n_products = 0
    changed = True
    while n_products < n_iter and changed:
        rn = r | impl(r, r)
        changed = bool(torch.any(rn != r))
        r = rn
        n_products += 1
    if with_stats:
        return r, n_products
    return r


def is_acyclic(adj_packed: torch.Tensor,
               matmul_impl: Optional[MatmulImpl] = None) -> torch.Tensor:
    t = transitive_closure(adj_packed, matmul_impl)
    idx = torch.arange(adj_packed.shape[0], dtype=torch.int32,
                       device=adj_packed.device)
    return ~torch.any(bitset.bit_get(t, idx, idx))
