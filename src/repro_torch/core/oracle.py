"""Sequential oracle: the paper's sequential specification in plain Python.

The port's own copy of `repro.core.oracle` (the port imports nothing of
the JAX package); op codes come from the port's `core/dag.py`.

Used by tests/benchmarks to establish linearizability-by-construction: the
batched engine's outcome must equal sequential replay of the batch in the
documented linearization order (phase order, then batch-index order; within
an AddEdge sub-batch, the relaxed joint-abort semantics apply).
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

from repro_torch.core import dag as d


class SeqGraph:
    """Reference directed graph with the paper's sequential spec."""

    def __init__(self, capacity: int | None = None):
        self.vertices: Set[int] = set()
        self.edges: Set[Tuple[int, int]] = set()
        self.capacity = capacity
        self.n_overflow = 0

    # -- vertex ops -------------------------------------------------------
    def add_vertex(self, u: int) -> bool:
        if u in self.vertices:
            return True
        if self.capacity is not None and len(self.vertices) >= self.capacity:
            self.n_overflow += 1
            return False
        self.vertices.add(u)
        return True

    def remove_vertex(self, u: int) -> bool:
        if u not in self.vertices:
            return False
        self.vertices.remove(u)
        self.edges = {(a, b) for (a, b) in self.edges if a != u and b != u}
        return True

    # -- edge ops ---------------------------------------------------------
    def add_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        self.edges.add((u, v))
        return True

    def remove_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        self.edges.discard((u, v))
        return True

    def path_exists(self, u: int, v: int) -> bool:
        """True iff a path of >= 1 edge goes u -> v."""
        if u not in self.vertices or v not in self.vertices:
            return False
        frontier = {b for (a, b) in self.edges if a == u}
        seen = set(frontier)
        while frontier:
            if v in frontier:
                return True
            frontier = {b for (a, b) in self.edges
                        if a in frontier and b not in seen}
            seen |= frontier
        return v in seen

    def acyclic_add_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        if (u, v) in self.edges:
            return True
        if u == v:
            return False
        if self.path_exists(v, u):
            return False
        self.edges.add((u, v))
        return True

    def acyclic_add_edges_joint(self, pairs: Sequence[Tuple[int, int]],
                                method: str = "closure") -> List[bool]:
        """The batched relaxed spec: insert all candidates in transit, reject
        every candidate on a cycle of G ∪ transit (joint aborts).

        ``method`` mirrors the engine's two cycle-check algorithms:
        "closure" answers each v -> u query from the full reach set of v
        (algorithm 1); "partial" runs the scoped early-exit scan of
        `core/snapshot.py` (algorithm 2).  Both decide identically — the
        spec-level agreement the property tests pin down.
        """
        oks: List[bool] = [False] * len(pairs)
        cand: List[int] = []
        for i, (u, v) in enumerate(pairs):
            if u not in self.vertices or v not in self.vertices:
                oks[i] = False
            elif (u, v) in self.edges:
                oks[i] = True
            elif u == v:
                oks[i] = False
            else:
                cand.append(i)
        transit = set(self.edges)
        for i in cand:
            transit.add(pairs[i])
        # reject candidates on any cycle of transit graph
        for i in cand:
            u, v = pairs[i]
            if method == "partial":
                # algorithm-2 spec: scoped scan from v, stopping at the
                # deciding depth (u found, or the frontier died)
                cyc = _path_exists_in(transit, v, u)
            else:
                # algorithm-1 spec: the complete reach set of v, no early exit
                cyc = u in _full_reach_set(transit, v)
            oks[i] = not cyc
        for i in cand:
            if oks[i]:
                self.edges.add(pairs[i])
        return oks

    # -- reads ------------------------------------------------------------
    def contains_vertex(self, u: int) -> bool:
        return u in self.vertices

    def contains_edge(self, u: int, v: int) -> bool:
        return (u in self.vertices and v in self.vertices
                and (u, v) in self.edges)

    def is_acyclic(self) -> bool:
        return all(not _path_exists_in(self.edges, u, u) for u in self.vertices)


def _path_exists_in(edges: Set[Tuple[int, int]], u: int, v: int) -> bool:
    frontier = {b for (a, b) in edges if a == u}
    seen = set(frontier)
    while frontier:
        if v in frontier:
            return True
        frontier = {b for (a, b) in edges if a in frontier and b not in seen}
        seen |= frontier
    return v in seen


def _full_reach_set(edges: Set[Tuple[int, int]], u: int) -> Set[int]:
    """Algorithm-1 spec: the complete strict reach set of u (no early exit)."""
    frontier = {b for (a, b) in edges if a == u}
    seen = set(frontier)
    while frontier:
        frontier = {b for (a, b) in edges if a in frontier and b not in seen}
        seen |= frontier
    return seen


def apply_op_batch_oracle(g: SeqGraph, ops, a, b, acyclic: bool = False,
                          subbatches: int = 1,
                          method: str = "closure") -> List[bool]:
    """Replay a mixed batch in the engine's linearization order."""
    n = len(ops)
    res: List[bool] = [False] * n
    for i in range(n):
        if ops[i] == d.REMOVE_VERTEX:
            res[i] = g.remove_vertex(int(a[i]))
    for i in range(n):
        if ops[i] == d.ADD_VERTEX:
            res[i] = g.add_vertex(int(a[i]))
    for i in range(n):
        if ops[i] == d.REMOVE_EDGE:
            res[i] = g.remove_edge(int(a[i]), int(b[i]))
    edge_idx = [i for i in range(n) if ops[i] == d.ADD_EDGE]
    if acyclic:
        per = max(1, len(edge_idx) // subbatches) if edge_idx else 1
        # NB: engine sub-batches over the *whole* batch layout; for oracle
        # comparison tests we use uniform op batches where this matches.
        chunks = [edge_idx[i:i + per] for i in range(0, len(edge_idx), per)]
        for chunk in chunks:
            oks = g.acyclic_add_edges_joint(
                [(int(a[i]), int(b[i])) for i in chunk], method=method)
            for i, ok in zip(chunk, oks):
                res[i] = ok
    else:
        for i in edge_idx:
            res[i] = g.add_edge(int(a[i]), int(b[i]))
    for i in range(n):
        if ops[i] == d.CONTAINS_VERTEX:
            res[i] = g.contains_vertex(int(a[i]))
        elif ops[i] == d.CONTAINS_EDGE:
            res[i] = g.contains_edge(int(a[i]), int(b[i]))
    return res
